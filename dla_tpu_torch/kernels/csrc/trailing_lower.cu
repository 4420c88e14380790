// Trailing update over the lower tile pairs of a dense matrix: C <- C - P * P^T.
//
// Replaces dla_tpu/kernels/pallas_tiles.py:trailing_update_lower (the one
// Pallas kernel on the single-device POTRF main path).
//
// What it computes. The window of C that starts at element (off, off) is cut
// into tb x tb tiles. For every tile pair (i >= j) of that window the whole
// tile, strict-upper elements of the diagonal tiles included, becomes
// C[tile] - P_i * P_j^T. Every other element of C is left untouched, so the
// update is in place and the strictly-upper tiles pass through bit for bit.
// P holds the w = m - off panel rows, row-major with leading dimension ldp.
//
// The block body, the precision tiers, the design and what bounds it are in
// trailing_block.cuh, shared with the packed kernel (trailing_packed.cu);
// this file supplies the dense window's address map. m*m passes 2^31 at
// m = 46341, so the offsets are 64-bit.

#include "trailing_block.cuh"

namespace {

// element (r, c) of the window: C[off + r, off + c], leading dimension ldc
template <typename T>
struct DenseWindow {
  T* c;
  long long ldc, off;
  __device__ __forceinline__ T* operator()(long long r, long long col) const {
    return c + (off + r) * ldc + off + col;
  }
};

template <typename T>
int run(void* c, const void* p, long long w, long long nb, long long ldc, long long ldp,
        long long off, long long tb, int tier, void* stream) {
  return dla::launch_trailing<T>(tier, p, w, nb, ldp, tb, DenseWindow<T>{(T*)c, ldc, off},
                                 stream);
}

}  // namespace

// C interface, loaded with ctypes. c is the full matrix (leading dimension
// ldc), p the panel (w x nb, leading dimension ldp), off = origin * tb. Each
// returns cudaGetLastError() after the launch; 0 means launched.
extern "C" int dla_trailing_lower_f32(void* c, const void* p, long long w,
                                      long long nb, long long ldc, long long ldp,
                                      long long off, long long tb, int tier,
                                      void* stream) {
  return run<float>(c, p, w, nb, ldc, ldp, off, tb, tier, stream);
}

extern "C" int dla_trailing_lower_f64(void* c, const void* p, long long w,
                                      long long nb, long long ldc, long long ldp,
                                      long long off, long long tb, int tier,
                                      void* stream) {
  return run<double>(c, p, w, nb, ldc, ldp, off, tb, tier, stream);
}

extern "C" int dla_trailing_lower_bf16(void* c, const void* p, long long w,
                                       long long nb, long long ldc, long long ldp,
                                       long long off, long long tb, int tier,
                                       void* stream) {
  return run<__nv_bfloat16>(c, p, w, nb, ldc, ldp, off, tb, tier, stream);
}
