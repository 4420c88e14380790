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
// The three block bodies (trailing_wgmma.cuh: bf16 tensor cores, for fp32
// high and default and bf16 storage; trailing_chain.cuh: an fp32 FMA chain
// on the SIMT pipes for fp32 highest, an fp64 chain on the fp64 tensor cores
// for fp64), the precision tiers, the design and what bounds each are in
// those headers, shared with the packed kernel (trailing_packed.cu); this
// file supplies the dense window's address map. m*m passes 2^31 at
// m = 46341, so the offsets are 64-bit.

#include "trailing_chain.cuh"

namespace {

// element (r, c) of the window: C[off + r, off + c], leading dimension ldc;
// the offset is row(r) + col(c), which the tensor-core body's epilogue
// computes once per row and once per column
template <typename T>
struct DenseWindow {
  T* c;
  long long ldc, off;
  __device__ __forceinline__ long long row(long long r) const { return (off + r) * ldc; }
  __device__ __forceinline__ long long col(long long cc) const { return off + cc; }
  __device__ __forceinline__ T* at(long long row_off, long long col_off) const {
    return c + row_off + col_off;
  }
  __device__ __forceinline__ T* operator()(long long r, long long cc) const {
    return at(row(r), col(cc));
  }
};

template <typename T>
int run(void* c, const void* p, void* scratch, long long w, long long nb, long long ldc,
        long long ldp, long long off, long long tb, long long scratch_bytes, int tier,
        void* stream) {
  return dla::launch_trailing<T>(tier, p, w, nb, ldp, tb, DenseWindow<T>{(T*)c, ldc, off},
                                 scratch, scratch_bytes, stream);
}

}  // namespace

// C interface, loaded with ctypes. c is the full matrix (leading dimension
// ldc), p the panel (w x nb, leading dimension ldp), off = origin * tb,
// scratch the wrapper's scratch_bytes for the split planes of P (unused by
// the chain bodies). Each returns the CUDA error of the first step that
// failed; 0 means launched.
extern "C" int dla_trailing_lower_f32(void* c, const void* p, void* scratch, long long w,
                                      long long nb, long long ldc, long long ldp, long long off,
                                      long long tb, long long scratch_bytes, int tier,
                                      void* stream) {
  return run<float>(c, p, scratch, w, nb, ldc, ldp, off, tb, scratch_bytes, tier, stream);
}

extern "C" int dla_trailing_lower_f64(void* c, const void* p, void* scratch, long long w,
                                      long long nb, long long ldc, long long ldp, long long off,
                                      long long tb, long long scratch_bytes, int tier,
                                      void* stream) {
  return run<double>(c, p, scratch, w, nb, ldc, ldp, off, tb, scratch_bytes, tier, stream);
}

extern "C" int dla_trailing_lower_bf16(void* c, const void* p, void* scratch, long long w,
                                       long long nb, long long ldc, long long ldp, long long off,
                                       long long tb, long long scratch_bytes, int tier,
                                       void* stream) {
  return run<__nv_bfloat16>(c, p, scratch, w, nb, ldc, ldp, off, tb, scratch_bytes, tier, stream);
}

// Launches of both trailing kernels (this one and trailing_packed.cu) in this
// process through the SIMT body (body = 0), the bf16 tensor-core body (1) or
// the DMMA body (2).
extern "C" long long dla_trailing_body_launches(int body) {
  return body >= 0 && body < 3 ? dla::trailing_body_launches[body] : 0;
}

// One fp64 tensor-core instruction on given operands, the DMMA body's own
// wrapper: D = C + A * B^T for mma.sync.m16n8k`shape` (shape 4, 8 or 16;
// A 16 x shape, B 8 x shape, C and D 16 x 8) or, shape 0, m8n8k4 (A and B
// 8 x 4, C and D 8 x 8); row-major device arrays. The card tests hold it to
// an exact chain of fma roundings. Returns a CUDA error.
extern "C" int dla_dmma_probe(const double* a, const double* b, const double* c, double* d,
                              int shape, void* stream) {
  return dla::chain::probe(a, b, c, d, shape, (cudaStream_t)stream);
}
