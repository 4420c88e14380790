// The scalar block body of the two trailing-update kernels: C <- C - P * P^T
// over the lower tb-tile pairs of a square window, in place.
//
// trailing_lower.cu writes the window into a dense matrix, trailing_packed.cu
// into the column-slab packed triangle. They differ only in where element
// (r, c) of the window lives, so the staging, the k-loop, the precision tiers
// and the epilogue are here once, templated on an address functor
// Addr(r, c) -> T*, and the two kernels cannot drift apart. This body serves
// the tiers the tensor cores cannot (fp32 highest, fp64); the others run the
// tensor-core body of trailing_wgmma.cuh, which also holds the launch that
// picks a body. The k-loop is nt_block, a 64 x 64 block of A * B^T; the panel
// kernels (panel_factor.cu, panel_apply.cu) and the task kernels
// (tile_ops.cu) form their products with it at every tier, so those
// products follow one definition of the tiers.
//
// What a block computes. The window's w rows and columns are cut into
// tb x tb tiles (the ragged last tile included). A 2-D grid of 64 x 64
// output blocks covers the window; a block returns at once when all of it
// lies in tiles above the diagonal, so the lower-pairs-only walk needs no
// host pair table. Every element with r/tb >= c/tb becomes
// C[r, c] - sum_k P[r, k] * P[c, k] (whole diagonal tiles, strict-upper
// elements included); every other element is never written. The mask and
// the address are per element, so a block may straddle tile and slab
// boundaries. P holds the window's w rows, row-major with leading
// dimension ldp, and nb columns.
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

// The trailing update at fp32 highest and fp64 (trailing_wgmma.cuh takes
// the other tiers).
template <typename T, typename Addr>
__global__ void __launch_bounds__(TPB)
trailing_kernel(const T* __restrict__ p, long long w, long long nb, long long ldp,
                long long tb, Addr addr) {
  using A = typename AccOf<T>::type;

  const long long row0 = (long long)blockIdx.y * BM;
  const long long col0 = (long long)blockIdx.x * BM;
  const long long last_row = min(row0 + BM, w) - 1;
  if (last_row / tb < col0 / tb) return;  // every element in an upper tile

  A acc[TM][TM];
  A accx[TM][TM];  // nt_block's cross terms, unused at highest
  nt_block<T, kHighest>(p + row0 * ldp, ldp, w - row0, p + col0 * ldp, ldp, w - col0, nb, acc,
                        accx);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long r = row0 + ty + 16 * i;
    if (r >= w) continue;
    const long long rtile = r / tb;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const long long cc = col0 + tx + 16 * j;
      if (cc >= w || cc / tb > rtile) continue;
      subtract(addr(r, cc), acc[i][j]);
    }
  }
}

}  // namespace dla
