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
// Design, precision and bound: this is the tiled schedule of diag_block.cuh
// (launch_diag: ceil(n / 64) + 1 launches of up to 29 blocks), the phase
// that panel_factor.cu runs first, launched alone; the two share the code and
// so the bits. The tile is capped at n <= 512 (the Pallas kernel only needs
// the tile to fit VMEM and states no cap; the reference's best tile is
// NB = 448). The chain of n pivots bounds it: it is bound by latency, not by
// bytes or operations.

#include "diag_block.cuh"

namespace {

template <typename T>
int run(const void* a, void* l, void* linv, long long n, long long lda, int tier,
        void* stream) {
  return dla::launch_diag<T>(tier, (const T*)a, lda, (T*)l, (T*)linv, n, (cudaStream_t)stream);
}

}  // namespace

// C interface, loaded with ctypes. Returns the first CUDA error of the
// launches, or cudaErrorInvalidValue, before any launch, when n > 512; 0
// means launched.
extern "C" int dla_potrf_tile_f32(const void* a, void* l, void* linv, long long n,
                                  long long lda, int tier, void* stream) {
  return run<float>(a, l, linv, n, lda, tier, stream);
}

extern "C" int dla_potrf_tile_f64(const void* a, void* l, void* linv, long long n,
                                  long long lda, int tier, void* stream) {
  return run<double>(a, l, linv, n, lda, tier, stream);
}

// The schedule's shape at n: its launches, and the largest grid among them
// (so a caller can show that it runs on more than one SM).
extern "C" int dla_diag_schedule(long long n, int* launches, int* max_blocks) {
  if (n <= 0 || n > dla::kMaxNb) return (int)cudaErrorInvalidValue;
  const int nt = dla::diag_tiles(n);
  *launches = nt + 1;
  *max_blocks = 0;
  for (int t = 0; t <= nt; ++t)
    if (dla::stage_blocks(nt, t) > *max_blocks) *max_blocks = dla::stage_blocks(nt, t);
  return 0;
}
