// Trailing update over the column-slab packed lower triangle: packed <- packed - P * P^T.
//
// Replaces dla_tpu/kernels/pallas_tiles.py:trailing_update_packed (and its
// host tables, _packed_pairs), the Pallas kernel of potrf_packed's
// trailing="pallas" path.
//
// The packed layout and the window's offset map are in packed_window.cuh.
//
// What it computes. At packed step k the trailing window is the m x m square
// of global indices base = (k+1)*w .. n-1. For window element (r, c) with
// r/tb >= c/tb (whole diagonal tb-tiles; nothing in the tb-tiles above the
// diagonal inside a diagonal w-block), packed[R, C] -= (P * P^T)[r, c],
// where R = base + r, C = base + c, and the element lives in slab j = C / w
// at buffer offset (row_offset(j) + R - j*w) * w + C - j*w. Every other
// element passes through bit for bit. P is the solved panel's m rows
// (m x w, leading dimension ldp).
//
// Design. The reference drives a sequential TPU grid from four prefetched
// index tables. Here no table is needed: the block bodies are the dense
// kernel's (trailing_wgmma.cuh for fp32 high and default and bf16 storage,
// trailing_chain.cuh for fp32 highest and fp64: output blocks that find
// their own window coordinates from blockIdx, the k-loop, the precision
// tiers), and only the address map differs (PackedWindow, shared with the
// df64 packed kernel). The buffer
// holds rows * w = 3.5e9 elements at n = 81920, w = 4096 (5.9e9 at
// n = 106496), past 2^31, so every offset is 64-bit.
//
// Bound. As the dense kernel: the tensor-core body is bound by its bf16
// products (w operations per element and pass against one read and one
// write), the chain bodies by their fp32 FMAs and fp64 tensor-core products.

#include "packed_window.cuh"
#include "trailing_chain.cuh"

namespace {

// element (r, c) of the trailing window of packed step k, base = (k+1)*w
template <typename T>
struct PackedTrailing {
  T* packed;
  dla::PackedWindow win;
  __device__ __forceinline__ long long row(long long r) const { return win.row(r); }
  __device__ __forceinline__ long long col(long long c) const { return win.col(c); }
  __device__ __forceinline__ T* at(long long row_off, long long col_off) const {
    return packed + row_off + col_off;
  }
  __device__ __forceinline__ T* operator()(long long r, long long c) const {
    return packed + win(r, c);
  }
};

template <typename T>
int run(void* packed, const void* p, void* scratch, long long m, long long w, long long ldp,
        long long base, long long nt, long long tb, long long scratch_bytes, int tier,
        void* stream) {
  return dla::launch_trailing<T>(tier, p, m, w, ldp, tb,
                                 PackedTrailing<T>{(T*)packed, {w, nt, base}}, scratch,
                                 scratch_bytes, stream);
}

}  // namespace

// C interface, loaded with ctypes. packed is the (n(n+w)/(2w), w) buffer,
// p the panel (m x w, leading dimension ldp) with m = n - base, base =
// (k+1)*w, nt = n / w, tb the tile of the lower-pairs mask, scratch the
// wrapper's scratch_bytes for the split planes of P (unused by the chain
// bodies). Each returns the CUDA error of the first step that failed; 0 means
// launched.
extern "C" int dla_trailing_packed_f32(void* packed, const void* p, void* scratch,
                                       long long m, long long w, long long ldp, long long base,
                                       long long nt, long long tb, long long scratch_bytes,
                                       int tier, void* stream) {
  return run<float>(packed, p, scratch, m, w, ldp, base, nt, tb, scratch_bytes, tier, stream);
}

extern "C" int dla_trailing_packed_f64(void* packed, const void* p, void* scratch,
                                       long long m, long long w, long long ldp, long long base,
                                       long long nt, long long tb, long long scratch_bytes,
                                       int tier, void* stream) {
  return run<double>(packed, p, scratch, m, w, ldp, base, nt, tb, scratch_bytes, tier, stream);
}

extern "C" int dla_trailing_packed_bf16(void* packed, const void* p, void* scratch,
                                        long long m, long long w, long long ldp, long long base,
                                        long long nt, long long tb, long long scratch_bytes,
                                        int tier, void* stream) {
  return run<__nv_bfloat16>(packed, p, scratch, m, w, ldp, base, nt, tb, scratch_bytes, tier, stream);
}
