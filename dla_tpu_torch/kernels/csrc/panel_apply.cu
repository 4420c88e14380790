// Panel apply: the panel solve X * L^T = B as a blocked TRSM.
//
// Replaces dla_tpu/kernels/pallas_tiles.py:panel_apply (body
// _panel_apply_kernel).
//
// What it computes. B is (m, nb), L = lkk is (nb, nb) lower triangular, both
// row-major; dinv is the (nb, ib) stack of inv(L_jj) for the nb/ib diagonal
// blocks, built by the wrapper. Over the column blocks j in order,
//   X_j = (B_j - sum_{i<j} X_i * L_{j,i}^T) * inv(L_jj)^T,
// every product at the tier as the reference's _dot_nt (bf16x3 at high, the
// fp32 right-hand side itself split into bf16 hi and lo; one bf16 pass at
// default; IEEE fp32 at highest), accumulated in fp32. fp32 only: the
// reference accumulates in fp32 whatever it is given.
//
// Design. Rows are independent and the column blocks of a row are
// sequential, so one thread block owns a 64-row strip and loops over j
// (the Pallas kernel's grid runs over tb-row tiles on one core; here the
// strips run in parallel on every SM). The strip's running X (64 x nb, 256 KB
// at nb = 1024) does not fit in shared memory: it lives in out, in device
// memory, and is read back by the same block after a __syncthreads(). The
// current right-hand side goes to a (64, ib) slice of the rhs scratch, since
// every column of X_j needs all of it. Each product is a sequence of 64 x 64
// nt_block calls (trailing_block.cuh).
//
// Bound. m*nb*(nb + ib) operations against 2*m*nb*4 bytes of B and X: at
// nb = 1024 it is bound by scalar FMA issue, like the trailing kernels. With
// m / 64 blocks (240 at m = 15360) the card runs under two waves.
// Tensor-core products are the next step.

#include "trailing_block.cuh"

namespace {

using dla::BM;
using dla::TM;
using dla::TPB;

template <int TIER>
__global__ void __launch_bounds__(TPB)
apply_kernel(const float* __restrict__ b, long long ldb, const float* __restrict__ lkk,
             long long ldl, const float* __restrict__ dinv, float* out, float* rhs, long long m,
             long long nb, long long ib) {
  const long long row0 = (long long)blockIdx.x * BM;
  const long long rows = min((long long)BM, m - row0);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float* x = out + row0 * nb;  // this strip's X, leading dimension nb
  float* r = rhs + row0 * ib;  // this strip's right-hand side, leading dimension ib
  float acc[TM][TM];
  float accx[TM][TM];

  for (long long j0 = 0; j0 < nb; j0 += ib) {
    // r = B_j - X_{<j} * L_{j,<j}^T, 64 columns at a time
    for (long long c0 = 0; c0 < ib; c0 += BM) {
      dla::nt_block<float, TIER>(x, nb, rows, lkk + (j0 + c0) * ldl, ldl, ib - c0, j0, acc,
                                 accx);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const long long rr = ty + 16 * i;
        if (rr >= rows) continue;
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          const long long cc = c0 + tx + 16 * j;
          if (cc >= ib) continue;
          const float sub = TIER == dla::kHigh ? acc[i][j] + accx[i][j] : acc[i][j];
          r[rr * ib + cc] = b[(row0 + rr) * ldb + j0 + cc] - sub;
        }
      }
    }
    __syncthreads();  // r complete before any column of X_j reads it
    // X_j = r * inv(L_jj)^T
    for (long long c0 = 0; c0 < ib; c0 += BM) {
      dla::nt_block<float, TIER>(r, ib, rows, dinv + (j0 + c0) * ib, ib, ib - c0, ib, acc,
                                 accx);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const long long rr = ty + 16 * i;
        if (rr >= rows) continue;
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          const long long cc = c0 + tx + 16 * j;
          if (cc >= ib) continue;
          x[rr * nb + j0 + cc] = TIER == dla::kHigh ? acc[i][j] + accx[i][j] : acc[i][j];
        }
      }
    }
    __syncthreads();  // X_j complete before the next block's correction reads it
  }
}

}  // namespace

// C interface, loaded with ctypes: b (m x nb, leading dimension ldb), lkk
// (nb x nb, leading dimension ldl), dinv (nb x ib, contiguous), out (m x nb,
// contiguous), rhs (m x ib scratch). Returns cudaGetLastError() after the
// launch; 0 means launched.
extern "C" int dla_panel_apply_f32(const void* b, const void* lkk, const void* dinv, void* out,
                                   void* rhs, long long m, long long nb, long long ib,
                                   long long ldb, long long ldl, int tier, void* stream) {
  if (m <= 0) return 0;
  if (ib <= 0 || nb % ib || ldb < nb || ldl < nb) return (int)cudaErrorInvalidValue;
  const long long g = (m + BM - 1) / BM;
  if (g > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* pb = (const float*)b;
  const float* pl = (const float*)lkk;
  const float* pd = (const float*)dinv;
  float* po = (float*)out;
  float* pr = (float*)rhs;
  switch (tier) {
    case dla::kHighest:
      apply_kernel<dla::kHighest><<<(unsigned)g, TPB, 0, s>>>(pb, ldb, pl, ldl, pd, po, pr, m,
                                                               nb, ib);
      break;
    case dla::kHigh:
      apply_kernel<dla::kHigh><<<(unsigned)g, TPB, 0, s>>>(pb, ldb, pl, ldl, pd, po, pr, m,
                                                            nb, ib);
      break;
    case dla::kDefault:
      apply_kernel<dla::kDefault><<<(unsigned)g, TPB, 0, s>>>(pb, ldb, pl, ldl, pd, po, pr, m,
                                                               nb, ib);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
