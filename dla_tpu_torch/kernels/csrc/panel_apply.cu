// Panel apply: the panel solve X * L^T = B as a blocked TRSM.
//
// Replaces dla_tpu/kernels/pallas_tiles.py:panel_apply (body
// _panel_apply_kernel).
//
// What it computes. B is (m, nb), L = lkk is (nb, nb) lower triangular, both
// row-major with their own leading dimensions; dinv is the (nb, ib) stack of
// inv(L_jj) for the nb/ib diagonal blocks, built by the wrapper. Over the
// column blocks j in order,
//   X_j = (B_j - sum_{i<j} X_i * L_{j,i}^T) * inv(L_jj)^T,
// every product at the tier as the reference's _dot_nt (bf16x3 at high, the
// fp32 right-hand side itself split into bf16 hi and lo; one bf16 pass at
// default; IEEE fp32 at highest), accumulated in fp32. fp32 only: the
// reference accumulates in fp32 whatever it is given. B is only read: in
// potrf_inplace it is a view of the matrix being factored.
//
// Design. A chain of 2 * nb/ib - 1 products of tile_body.cuh, all on the
// caller's stream, each over the whole of m (kernels/panel.py:
// panel_apply_schedule lists them):
//   j = 0   X_0 = B_0 * inv(L_00)^T                      trsm epilogue, k = ib
//   j > 0   rhs = B_j - X_{<j} * L_{j,<j}^T              gemm epilogue, k = j*ib
//           X_j = rhs * inv(L_jj)^T                      trsm epilogue, k = ib
// The correction sums over all j*ib columns in one product (the reference
// subtracts one ib block at a time); rhs is an (m, ib) scratch, and X_j is
// written straight into its columns of out (leading dimension nb). Each
// product is a grid of output tiles, so the parallelism comes from m and ib
// together, not from row strips alone. The bodies, by tier (no other route,
// no retry through another body):
//   fp32 high      tile_tc_kernel, two bf16 planes (bf16x3 on wgmma)
//   fp32 default   tile_tc_kernel, one plane
//   fp32 highest   tile_simt_kernel, one IEEE fp32 fma chain per output in
//                  ascending k from +0 (launch_chain: the scalar body
//                  tile_kernel's bits, product by product)
// The tensor-core body's split kernel writes each product's planes into one
// scratch, sized by the wrapper for the largest product and reused by every
// product in stream order.
//
// Bound. m*nb*(nb + ib) operations against 2*m*nb*4 bytes of B and X: bf16
// products at high and default, fp32 FMA issue at highest. Each product adds a
// split launch and a main launch (14 at nb = 1024, ib = 256); on the short
// panels at the end of a factorization a product has few output tiles (16 at
// m = 1024), so the chain's latency, not its work, sets the time.

#include "tile_body.cuh"

namespace {

// calls of this kernel in this process through each body (TileBody of
// tile_body.cuh: kScalar, which no call takes any more, kWgmma, kSimt),
// counted where every product of a call launched
long long panel_body_launches[3] = {0, 0, 0};

template <int EPI>
int product(int tier, const float* c, long long ldc, const float* a, long long lda,
            const float* b, long long ldb, float* out, long long ldo, long long m, long long n,
            long long k, void* scratch, long long scratch_bytes, cudaStream_t s) {
  switch (tier) {
    case dla::kHighest:
      return launch_chain<float, EPI>(c, a, b, out, m, n, k, ldc, lda, ldb, ldo, 0, s);
    case dla::kHigh:
      return launch_tc<float, 2, EPI>(c, a, b, out, m, n, k, ldc, lda, ldb, ldo, scratch,
                                      scratch_bytes, s);
    case dla::kDefault:
      return launch_tc<float, 1, EPI>(c, a, b, out, m, n, k, ldc, lda, ldb, ldo, scratch,
                                      scratch_bytes, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface, loaded with ctypes: b (m x nb, leading dimension ldb), lkk
// (nb x nb, leading dimension ldl), dinv (nb x ib, contiguous), out (m x nb,
// contiguous), rhs (m x ib scratch; may be null when ib = nb), scratch
// (scratch_bytes for the tensor-core body's split planes of the largest
// product; the chain body reads neither). Every argument is checked before
// anything launches. Returns the CUDA error of the first step that failed;
// 0 means every product launched.
extern "C" int dla_panel_apply_f32(const void* b, const void* lkk, const void* dinv, void* out,
                                   void* rhs, void* scratch, long long m, long long nb,
                                   long long ib, long long ldb, long long ldl,
                                   long long scratch_bytes, int tier, void* stream) {
  if (m <= 0) return 0;
  if (ib <= 0 || nb % ib || ldb < nb || ldl < nb || (nb > ib && rhs == nullptr))
    return (int)cudaErrorInvalidValue;
  if (tier != dla::kHighest && tier != dla::kHigh && tier != dla::kDefault)
    return (int)cudaErrorInvalidValue;
  const int planes = tier == dla::kHigh ? 2 : tier == dla::kDefault ? 1 : 0;
  const long long kmax = nb - ib > ib ? nb - ib : ib;  // the last correction, or an inverse
  if (planes && scratch_bytes < tc_scratch_bytes(planes, m, ib, kmax))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* pb = (const float*)b;
  const float* pl = (const float*)lkk;
  const float* pd = (const float*)dinv;
  float* px = (float*)out;
  float* pr = (float*)rhs;
  for (long long j0 = 0; j0 < nb; j0 += ib) {
    const float* r = pb + j0;  // the right-hand side of block j and its leading dimension
    long long ldr = ldb;
    if (j0 > 0) {  // rhs = B_j - X_{<j} * L_{j,<j}^T
      const int err = product<kGemm>(tier, pb + j0, ldb, px, nb, pl + j0 * ldl, ldl, pr, ib, m,
                                     ib, j0, scratch, scratch_bytes, s);
      if (err != 0) return err;
      r = pr;
      ldr = ib;
    }
    // X_j = rhs * inv(L_jj)^T, into columns j0 .. j0 + ib of out
    const int err = product<kTrsm>(tier, nullptr, 0, r, ldr, pd + j0 * ib, ib, px + j0, nb, m,
                                   ib, ib, scratch, scratch_bytes, s);
    if (err != 0) return err;
  }
  ++panel_body_launches[planes ? kWgmma : kSimt];
  return 0;
}

// Calls of dla_panel_apply_f32 in this process through the scalar body
// (body = 0: none), the tensor-core body (1) or the simt chain (2).
extern "C" long long dla_panel_apply_body_launches(int body) {
  return body >= 0 && body < 3 ? panel_body_launches[body] : 0;
}
