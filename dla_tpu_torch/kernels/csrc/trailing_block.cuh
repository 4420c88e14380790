// The scalar block body nt_block, C = A * B^T for a 64 x 64 block in IEEE
// fp32 or fp64 FMAs, and the precision helpers the trailing, panel and task
// kernels share.
//
// nt_block runs on no library path. It is the body of the task kernels'
// test-only bit reference (dla_tile_op_scalar_<f32|f64> of tile_ops.cu,
// through tile_kernel of tile_body.cuh). The chain bodies of
// trailing_chain.cuh, which every fp32 highest and fp64 product of the
// library runs (the trailing, task and panel kernels), keep its sum, one fma
// chain per element in ascending k over 16-column steps from +0, and so its
// bits; the card tests and chip_smoke.py hold them to it.
//
// Precision of the helpers, as the reference's _dot_nt (pallas_tiles.py:68-88)
// and its epilogue: round_bf16 gives the bf16 planes of high (x = hi + lo,
// hi = bf16(x), lo = bf16(x - hi)) and default; minus is the epilogue c - upd
// in the storage type, bf16(c - bf16(upd)) for bf16 storage as
// _trailing_kernel.
//
// Design of nt_block. 256 threads, each owning 4 x 4 outputs strided by 16
// so that neighbouring threads store neighbouring columns. The operands' row
// blocks are staged through shared memory 16 columns of k at a time. All
// element offsets are 64-bit.
//
// Bound. Scalar FMAs: bound by FMA issue and shared-memory reads, not by
// bytes.

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

// The 64 x 64 block a * b^T in acc, one fma chain per output in ascending k
// from +0. a holds ra valid rows (leading dimension lda), b rb valid rows
// (ldb), both k_len columns wide; rows past ra or rb, and k past k_len up to
// the next multiple of 16, count as zero, so ra and rb may exceed 64. Thread
// t owns rows t/16 + 16i and columns t%16 + 16j. Every thread of the block
// must call it; it ends on a __syncthreads().
template <typename T>
__device__ __forceinline__ void nt_block(const T* a, long long lda, long long ra, const T* b,
                                         long long ldb, long long rb, long long k_len,
                                         typename AccOf<T>::type (&acc)[TM][TM]) {
  using A = typename AccOf<T>::type;

  // [k][row], padded so the transposed stores do not conflict
  __shared__ A sa[BK][BM + 1];
  __shared__ A sb[BK][BM + 1];

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = A(0);

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
      sa[kk][r] = va;
      sb[kk][r] = vb;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      A x[TM], y[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        x[i] = sa[kk][ty + 16 * i];
        y[i] = sb[kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = mad(x[i], y[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace dla
