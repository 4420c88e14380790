// Panel factor: one column panel of a right-looking Cholesky step.
//
// Replaces dla_tpu/kernels/pallas_tiles.py:panel_factor (body _panel_kernel,
// with _factor_lower and _invert_lower).
//
// What it computes. The panel is (m, nb), m a multiple of nb, row-major with
// leading dimension ldp. Its first nb rows A_kk become tril(L_kk), the
// unblocked Cholesky factor read from the lower triangle only; every row
// below becomes A_ik * inv(L_kk)^T. out is (m, nb), contiguous; linv is an
// nb x nb scratch that receives inv(L_kk).
//
// Design. The Pallas kernel walks the TPU's sequential grid: step 0 factors
// the diagonal block and keeps inv(L_kk) in VMEM scratch, and the later
// steps read it. Blocks of a CUDA grid run in no order and share nothing, so
// the C entry launches two kernels on one stream:
//   (a) diag_kernel, ONE thread block of 1024 threads: the nb column steps
//       of the factor, then the nb row steps of the inverse, each a rank-1
//       update of the lower trailing triangle, with a __syncthreads() between
//       steps. It works in device memory (out's first nb rows and linv; at
//       nb = 512 fp32 each is 1 MB and stays in L2), with the current column
//       or row staged in shared memory.
//   (b) solve_kernel, a grid of 64 x 64 output blocks: out[nb:] =
//       panel[nb:] * linv^T through nt_block (trailing_block.cuh), at the
//       tier, as the reference's _dot_nt.
// Precision of (a), as _kernel_precision: fp32 products rounded once
// (high is promoted to highest), bf16-rounded operands at default (their
// products are exact in fp32), fp64 for fp64. Every product and difference
// is written with an _rn intrinsic, so nvcc contracts none of them into an
// FMA and (a) rounds where the plain version does.
//
// Bound. (a) is latency-bound: 2*nb dependent steps of one block, each a
// round trip to L2 and two barriers, on one SM. (b) is an NT product of
// 2*(m - nb)*nb^2 operations, bound like the trailing kernels by scalar FMA
// issue; it fills the card once m - nb is a few thousand rows. Keeping the
// diagonal block in registers and shared memory across a thread block
// cluster, and (b) on the tensor cores, are the next steps.

#include "trailing_block.cuh"

namespace {

using dla::BM;
using dla::TM;
using dla::TPB;

constexpr int kDiagThreads = 1024;
constexpr int kWarps = kDiagThreads / 32;
constexpr int kMaxNb = 512;  // the reference's VMEM cap, checked by the wrapper

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
  if constexpr (std::is_same_v<T, float> && TIER == dla::kDefault) {
    return dla::round_bf16(v);
  } else {
    return v;
  }
}

// (a): l <- tril(L_kk) of the panel's first nb rows, x <- inv(L_kk); both
// nb x nb with leading dimension nb. One block.
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

// (b): out[nb + r][c] = sum_k panel[nb + r][k] * linv[c][k], rows r < rows.
template <typename T, int TIER>
__global__ void __launch_bounds__(TPB)
solve_kernel(const T* __restrict__ panel, long long ldp, const T* __restrict__ linv,
             T* __restrict__ out, long long rows, long long nb) {
  using A = typename dla::AccOf<T>::type;
  const long long row0 = (long long)blockIdx.y * BM;
  const long long col0 = (long long)blockIdx.x * BM;
  A acc[TM][TM];
  A accx[TM][TM];
  dla::nt_block<T, TIER>(panel + (nb + row0) * ldp, ldp, rows - row0, linv + col0 * nb, nb,
                         nb - col0, nb, acc, accx);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long r = row0 + ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const long long c = col0 + tx + 16 * j;
      if (c >= nb) continue;
      out[(nb + r) * nb + c] = T(TIER == dla::kHigh ? acc[i][j] + accx[i][j] : acc[i][j]);
    }
  }
}

template <typename T, int TIER>
int launch(const T* panel, T* out, T* linv, long long m, long long nb, long long ldp,
           cudaStream_t s) {
  // (a) at _kernel_precision: only default differs from highest
  constexpr int kStep = TIER == dla::kDefault ? dla::kDefault : dla::kHighest;
  diag_kernel<T, kStep><<<1, kDiagThreads, 0, s>>>(panel, ldp, out, linv, (int)nb);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long rows = m - nb;
  if (rows > 0) {
    const long long gy = (rows + BM - 1) / BM;
    if (gy > 65535) return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)((nb + BM - 1) / BM), (unsigned)gy);
    solve_kernel<T, TIER><<<grid, TPB, 0, s>>>(panel, ldp, linv, out, rows, nb);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* panel, void* out, void* linv, long long m, long long nb, long long ldp,
        int tier, void* stream) {
  if (nb <= 0 || nb > kMaxNb || m % nb || ldp < nb) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const T* p = (const T*)panel;
  T* o = (T*)out;
  T* x = (T*)linv;
  if constexpr (std::is_same_v<T, float>) {
    switch (tier) {
      case dla::kHighest:
        return launch<T, dla::kHighest>(p, o, x, m, nb, ldp, s);
      case dla::kHigh:
        return launch<T, dla::kHigh>(p, o, x, m, nb, ldp, s);
      case dla::kDefault:
        return launch<T, dla::kDefault>(p, o, x, m, nb, ldp, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    (void)tier;  // fp64 has one tier
    return launch<T, dla::kHighest>(p, o, x, m, nb, ldp, s);
  }
}

}  // namespace

// C interface, loaded with ctypes: panel (m x nb, leading dimension ldp),
// out (m x nb, contiguous), linv (nb x nb scratch). Returns the first CUDA
// error of the two launches; 0 means both launched.
extern "C" int dla_panel_factor_f32(const void* panel, void* out, void* linv, long long m,
                                    long long nb, long long ldp, int tier, void* stream) {
  return run<float>(panel, out, linv, m, nb, ldp, tier, stream);
}

extern "C" int dla_panel_factor_f64(const void* panel, void* out, void* linv, long long m,
                                    long long nb, long long ldp, int tier, void* stream) {
  return run<double>(panel, out, linv, m, nb, ldp, tier, stream);
}
