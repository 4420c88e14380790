// The one-block factor-and-invert phase shared by panel_factor.cu and
// potrf_tile.cu: tril(L) of one SPD block and inv(L), so that the panel
// kernel and the tile task kernel cannot drift apart.
//
// Replaces _factor_lower and _invert_lower of dla_tpu/kernels/pallas_tiles.py
// (the math, not the masked column extraction that Mosaic needs).
//
// Design. ONE thread block of 1024 threads: the nb column steps of the
// factor, then the nb row steps of the inverse, each a rank-1 update of the
// lower trailing triangle, with a __syncthreads() between steps. It works in
// device memory (l and x; at nb = 512 fp32 each is 1 MB and stays in L2),
// with the current column or row staged in shared memory. The stage is a
// static array of kMaxNb elements, which caps the block at nb <= 512; the
// callers check it.
//
// Precision, as _kernel_precision (pallas_tiles.py:60-65): fp32 products
// rounded once (high is promoted to highest), bf16-rounded operands at
// default (their products are exact in fp32; the stored L is not rounded),
// fp64 for fp64. Every product and difference is written with an _rn
// intrinsic, so nvcc contracts none of them into an FMA and the kernel rounds
// where the plain version does.
//
// Bound. Latency: 2*nb dependent steps of one block, each a round trip to L2
// and two barriers, on one SM. Keeping the block in registers and shared
// memory across a thread block cluster is the next step.

#pragma once

#include "trailing_block.cuh"

namespace dla {

constexpr int kDiagThreads = 1024;
constexpr int kWarps = kDiagThreads / 32;
constexpr int kMaxNb = 512;  // the reference's VMEM cap of panel_factor; sizes the stage

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

// an operand of a rank-1 step: bf16-rounded at default (fp32 only)
template <typename T, int TIER>
__device__ __forceinline__ T step_operand(T v) {
  if constexpr (std::is_same_v<T, float> && TIER == kDefault) {
    return round_bf16(v);
  } else {
    return v;
  }
}

// l <- tril(L) of the nb x nb block at `panel` (leading dimension ldp, lower
// triangle read only), x <- inv(L); both nb x nb with leading dimension nb.
// One block.
template <typename T, int TIER>
__global__ void __launch_bounds__(kDiagThreads)
diag_kernel(const T* __restrict__ panel, long long ldp, T* l, T* x, int nb) {
  __shared__ T s[kMaxNb];  // the current column of L, then the current row of X
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  for (int e = tid; e < nb * nb; e += kDiagThreads) {
    const int r = e / nb, c = e % nb;
    l[e] = r >= c ? panel[r * ldp + c] : T(0);  // the upper triangle is never read
    x[e] = r == c ? T(1) : T(0);
  }
  __syncthreads();

  // the factor: column j scaled by its pivot, then l[r][c] -= l[r][j]*l[c][j]
  // for j < c <= r
  for (int j = 0; j < nb; ++j) {
    const T piv = sqrt_rn(l[j * nb + j]);
    for (int r = j + 1 + tid; r < nb; r += kDiagThreads) {
      const T v = div_rn(l[r * nb + j], piv);
      l[r * nb + j] = v;
      s[r] = step_operand<T, TIER>(v);
    }
    __syncthreads();  // every thread has read the pivot and s is complete
    if (tid == 0) l[j * nb + j] = piv;
    for (int r = j + 1 + warp; r < nb; r += kWarps) {
      const T sr = s[r];
      T* row = l + r * nb;
      for (int c = j + 1 + lane; c <= r; c += 32) row[c] = sub_rn(row[c], mul_rn(sr, s[c]));
    }
    __syncthreads();
  }

  // the inverse by forward substitution: row j of X divided by l[j][j], then
  // x[r][c] -= l[r][j]*x[j][c] for r > j, c <= j
  for (int j = 0; j < nb; ++j) {
    const T d = l[j * nb + j];
    for (int c = tid; c <= j; c += kDiagThreads) {
      const T v = div_rn(x[j * nb + c], d);
      x[j * nb + c] = v;
      s[c] = step_operand<T, TIER>(v);
    }
    __syncthreads();
    for (int r = j + 1 + warp; r < nb; r += kWarps) {
      const T lr = step_operand<T, TIER>(l[r * nb + j]);
      T* row = x + r * nb;
      for (int c = lane; c <= j; c += 32) row[c] = sub_rn(row[c], mul_rn(lr, s[c]));
    }
    __syncthreads();
  }
}

// Launch diag_kernel on `stream` at _kernel_precision of `tier`: only
// default differs from highest, and fp64 has one tier. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a block
// or tier the kernel does not take.
template <typename T>
int launch_diag(int tier, const T* panel, long long ldp, T* l, T* x, long long nb,
                cudaStream_t s) {
  if (nb <= 0 || nb > kMaxNb || ldp < nb || tier < kHighest || tier > kDefault)
    return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same_v<T, float>) {
    if (tier == kDefault) {
      diag_kernel<T, kDefault><<<1, kDiagThreads, 0, s>>>(panel, ldp, l, x, (int)nb);
      return (int)cudaGetLastError();
    }
  }
  diag_kernel<T, kHighest><<<1, kDiagThreads, 0, s>>>(panel, ldp, l, x, (int)nb);
  return (int)cudaGetLastError();
}

}  // namespace dla
