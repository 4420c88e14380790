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
// the C entry launches in two phases on one stream:
//   (a) launch_diag of diag_block.cuh (shared with potrf_tile.cu): the
//       tiled schedule, ceil(nb / 64) + 1 launches of up to 29 blocks of
//       64 x 64 tiles, factors and inverts the diagonal block into out's first
//       nb rows and linv.
//   (b) solve_kernel, a grid of 64 x 64 output blocks: out[nb:] =
//       panel[nb:] * linv^T through nt_block (trailing_block.cuh), at the
//       tier, as the reference's _dot_nt.
// Precision of (a), as _kernel_precision: see diag_block.cuh.
//
// Bound. (a) is latency-bound: a chain of nb pivots, 64 of them a stage.
// (b) is an NT product of 2*(m - nb)*nb^2 operations, bound like the
// trailing kernels by scalar FMA issue; it fills the card once m - nb is a
// few thousand rows. (b) on the tensor cores is the next step.

#include "diag_block.cuh"

namespace {

using dla::BM;
using dla::TM;
using dla::TPB;

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
  const int err = dla::launch_diag<T>(TIER, panel, ldp, out, linv, nb, s);  // (a)
  if (err != 0) return err;
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
  if (nb <= 0 || nb > dla::kMaxNb || m % nb || ldp < nb) return (int)cudaErrorInvalidValue;
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
// error of the launches; 0 means all launched.
extern "C" int dla_panel_factor_f32(const void* panel, void* out, void* linv, long long m,
                                    long long nb, long long ldp, int tier, void* stream) {
  return run<float>(panel, out, linv, m, nb, ldp, tier, stream);
}

extern "C" int dla_panel_factor_f64(const void* panel, void* out, void* linv, long long m,
                                    long long nb, long long ldp, int tier, void* stream) {
  return run<double>(panel, out, linv, m, nb, ldp, tier, stream);
}
