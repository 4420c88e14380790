// POTRF task kernel: (tril(L), inv(L)) of one SPD tile.
//
// Replaces dla_tpu/kernels/pallas_tiles.py:potrf_tile (body
// _potrf_inv_kernel: _factor_lower then _invert_lower), the POTRF task of the
// reference's tile DAG fused with the inverse of its factor, so that every
// TRSM task below it is a product (trsm_tile, tile_ops.cu).
//
// What it computes. a is (n, n), row-major with leading dimension lda; only
// its lower triangle is read. l receives tril(L), the unblocked Cholesky
// factor, and linv its inverse; both (n, n), contiguous, strict upper
// triangle zero.
//
// Design, precision and bound: this is diag_kernel of diag_block.cuh, the
// one-block phase that panel_factor.cu runs first, launched alone; the two
// share the code and so the bits. The tile is capped at n <= 512 by that
// kernel's shared-memory stage (the Pallas kernel only needs the tile to fit
// VMEM and states no cap; the reference's best tile is NB = 448). One block
// on one SM, 2*n dependent steps: the kernel is bound by latency, not by
// bytes or operations.

#include "diag_block.cuh"

namespace {

template <typename T>
int run(const void* a, void* l, void* linv, long long n, long long lda, int tier,
        void* stream) {
  return dla::launch_diag<T>(tier, (const T*)a, lda, (T*)l, (T*)linv, n, (cudaStream_t)stream);
}

}  // namespace

// C interface, loaded with ctypes. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue when n > 512; 0 means launched.
extern "C" int dla_potrf_tile_f32(const void* a, void* l, void* linv, long long n,
                                  long long lda, int tier, void* stream) {
  return run<float>(a, l, linv, n, lda, tier, stream);
}

extern "C" int dla_potrf_tile_f64(const void* a, void* l, void* linv, long long n,
                                  long long lda, int tier, void* stream) {
  return run<double>(a, l, linv, n, lda, tier, stream);
}
