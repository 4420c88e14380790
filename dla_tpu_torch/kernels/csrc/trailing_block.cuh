// The scalar block body nt_block, C += A * B^T for a 64 x 64 block, and the
// precision helpers the trailing, panel and task kernels share.
//
// nt_block is the body of the panel factor's products (panel_factor.cu,
// through diag_block.cuh), at every tier, and, at highest only, of the panel
// solve (panel_apply.cu) and of the task kernels' test-only bit reference
// (tile_ops.cu), both through tile_kernel of tile_body.cuh. The fp32 highest and fp64 bodies of
// the trailing kernels (trailing_chain.cuh) keep its sum, one fma chain per
// element in ascending k over 16-column steps, and so its bits.
//
// Precision, as the reference's _dot_nt (pallas_tiles.py:68-88):
//   float,  tier 0 (highest)  fp32 FMAs;
//   float,  tier 1 (high)     bf16x3: x = hi + lo with hi = bf16(x),
//                             lo = bf16(x - hi); hi*hi + (hi*lo + lo*hi),
//                             each bf16 x bf16 product exact in fp32;
//   float,  tier 2 (default)  bf16(a) * bf16(b), fp32 accumulation;
//   double                    fp64 FMAs;
//   bf16 storage              bf16 loads, fp32 accumulation, and the
//                             epilogue bf16(c - bf16(acc)) of _trailing_kernel.
//
// Design. 256 threads, each owning 4 x 4 outputs strided by 16 so that
// neighbouring threads store neighbouring columns. P's row blocks are staged
// through shared memory 16 columns of k at a time (for high, split into hi
// and lo once per load). All element offsets are 64-bit.
//
// Bound. Scalar FMAs: the kernel is bound by FMA issue and shared-memory
// reads, not by bytes, since each C element is read and written once while
// the k-loop does nb FMAs for it (three for high).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace dla {

constexpr int BM = 64;               // output block rows = cols
constexpr int BK = 16;               // k columns staged per step
constexpr int TPB = 256;             // threads per block (16 x 16)
constexpr int TM = 4;                // outputs per thread along each axis
constexpr int LOADS = BM * BK / TPB; // elements each thread stages per operand

enum Tier { kHighest = 0, kHigh = 1, kDefault = 2 };

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float mad(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double mad(double a, double b, double c) { return __fma_rn(a, b, c); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// c - upd in the storage type; bf16 storage as the reference's epilogue,
// bf16(c - bf16(upd))
__device__ __forceinline__ float minus(float c, float upd) { return c - upd; }
__device__ __forceinline__ double minus(double c, double upd) { return c - upd; }
__device__ __forceinline__ __nv_bfloat16 minus(__nv_bfloat16 c, float upd) {
  return __float2bfloat16_rn(__bfloat162float(c) - round_bf16(upd));
}

template <typename T, typename U>
__device__ __forceinline__ void subtract(T* c, U upd) { *c = minus(*c, upd); }

// The 64 x 64 block a * b^T, accumulated in acc (and, at high, the bf16x3
// cross terms hi*lo + lo*hi in accx; the product is acc + accx). a holds
// ra valid rows (leading dimension lda), b rb valid rows (ldb), both k_len
// columns wide; rows past ra or rb count as zero, so ra and rb may exceed
// 64. Thread t owns rows t/16 + 16i and columns t%16 + 16j. Every thread of
// the block must call it; it ends on a __syncthreads(). The pointers carry
// no __restrict__: the panel kernels read back what they wrote earlier in
// the same launch, which the read-only data path does not promise to see.
template <typename T, int TIER>
__device__ __forceinline__ void nt_block(const T* a, long long lda, long long ra, const T* b,
                                         long long ldb, long long rb, long long k_len,
                                         typename AccOf<T>::type (&acc)[TM][TM],
                                         typename AccOf<T>::type (&accx)[TM][TM]) {
  using A = typename AccOf<T>::type;
  constexpr bool kSplit = TIER == kHigh;
  constexpr int kPlanes = kSplit ? 2 : 1;

  // [plane][k][row], padded so the transposed stores do not conflict
  __shared__ A sa[kPlanes][BK][BM + 1];
  __shared__ A sb[kPlanes][BK][BM + 1];

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = accx[i][j] = A(0);

  for (long long k0 = 0; k0 < k_len; k0 += BK) {
#pragma unroll
    for (int e = 0; e < LOADS; ++e) {
      const int idx = threadIdx.x + e * TPB;
      const int r = idx / BK;
      const int kk = idx % BK;
      const long long k = k0 + kk;
      A va = A(0), vb = A(0);
      if (k < k_len) {
        if (r < ra) va = widen(a[r * lda + k]);
        if (r < rb) vb = widen(b[r * ldb + k]);
      }
      if constexpr (TIER == kHigh) {
        const float ha = round_bf16(va), hb = round_bf16(vb);
        sa[0][kk][r] = ha;
        sb[0][kk][r] = hb;
        sa[kPlanes - 1][kk][r] = round_bf16(va - ha);
        sb[kPlanes - 1][kk][r] = round_bf16(vb - hb);
      } else if constexpr (TIER == kDefault) {
        sa[0][kk][r] = round_bf16(va);
        sb[0][kk][r] = round_bf16(vb);
      } else {
        sa[0][kk][r] = va;
        sb[0][kk][r] = vb;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      A x[TM], y[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        x[i] = sa[0][kk][ty + 16 * i];
        y[i] = sb[0][kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = mad(x[i], y[j], acc[i][j]);
      if constexpr (kSplit) {
        A xl[TM], yl[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          xl[i] = sa[kPlanes - 1][kk][ty + 16 * i];
          yl[i] = sb[kPlanes - 1][kk][tx + 16 * i];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TM; ++j) {
            accx[i][j] = mad(x[i], yl[j], accx[i][j]);
            accx[i][j] = mad(xl[i], y[j], accx[i][j]);
          }
      }
    }
    __syncthreads();
  }
}

}  // namespace dla
