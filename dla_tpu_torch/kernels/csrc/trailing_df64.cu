// The df64 trailing update of a dense pair: (C_hi, C_lo) <- C - P * P^T over
// the lower tile pairs of a square window, in place on both fp32 planes, with
// P given as its s exact bf16 slices.
//
// Replaces dla_tpu/kernels/df64_tiles.py:trailing_update_df64 (the Pallas
// kernel of the emulated-fp64 dense POTRF, potrf_df64(trailing="pallas")).
//
// What it computes, its rounding order, the design and what bounds it are in
// trailing_df64.cuh, shared with the packed kernel (trailing_packed_df64.cu);
// this file supplies the dense window's offset map: the window starts at
// element (off, off) of the pair.

#include "trailing_df64.cuh"

namespace {

// element (r, c) of the window: C[off + r, off + c], leading dimension ldc,
// at offset row(r) + col(c)
struct DensePairWindow {
  long long ldc, off;
  __device__ __forceinline__ long long row(long long r) const { return (off + r) * ldc; }
  __device__ __forceinline__ long long col(long long c) const { return off + c; }
};

}  // namespace

// C interface, loaded with ctypes. ch and cl are the two planes of the full
// pair (leading dimension ldc), slices a host array of s device pointers to
// the w x nb slices (leading dimension ldp, as TMA asks: 16-byte aligned, ldp
// a multiple of 8), off = origin * tb, kb the exact chunk (nb a multiple of
// it). Returns the CUDA error of the first step that failed: 0 means
// launched.
extern "C" int dla_trailing_df64(void* ch, void* cl, const void* const* slices, long long w,
                                 long long nb, long long ldc, long long ldp, long long off,
                                 long long tb, long long kb, int s, int precise_deg,
                                 void* stream) {
  return dla::launch_trailing_df64(ch, cl, slices, w, nb, ldp, tb, kb, s, precise_deg,
                                   DensePairWindow{ldc, off}, stream);
}
