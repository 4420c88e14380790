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
//   (b) one NT product of tile_body.cuh with the trsm epilogue (m > nb only):
//       out[nb:] = panel[nb:] * linv^T, A the panel's rows below the block at
//       leading dimension ldp, B = linv, m - nb rows, n = k = nb. Its body
//       follows the tier as the task kernels' and panel_apply's do (no other
//       route, no retry through another body):
//         fp32 high      tile_tc_kernel, two bf16 planes (bf16x3 on wgmma, as
//                        the reference's _dot_nt)
//         fp32 default   tile_tc_kernel, one plane
//         fp32 highest   tile_simt_kernel   one fma chain per output in
//         fp64           tile_dmma_kernel   ascending k from +0: the scalar
//                                           body's bits (nt_block)
//       The tensor-core body's split kernel writes both operands' planes into
//       a scratch the wrapper allocates (tc_scratch_bytes(planes, m - nb, nb,
//       nb); kernels/panel.py:panel_factor_schedule sizes it alike).
// Precision of (a), as _kernel_precision: see diag_block.cuh.
//
// Bound. (a) is latency-bound: a chain of nb pivots, 64 of them a stage.
// (b) is an NT product of 2*(m - nb)*nb^2 operations over m*nb elements read
// and written: bound by the bf16 tensor cores at high (three passes), by the
// bytes at default, by fp32 FMA issue at highest and by the fp64 tensor cores
// for fp64. It fills the card once m - nb is a few thousand rows.

#include "diag_block.cuh"
#include "tile_body.cuh"

namespace {

// calls of this kernel in this process through the body of their tier
// (TileBody: kScalar stays 0, since no call takes that body), counted where
// every launch of the call succeeded; a call with m = nb launches no product
// and counts all the same
long long factor_body_launches[4] = {0, 0, 0, 0};

// bf16 planes of each operand that (b) takes on the tensor-core body; 0: a chain body
template <typename T>
int planes_of(int tier) {
  if constexpr (std::is_same_v<T, float>) {
    return tier == dla::kHigh ? 2 : tier == dla::kDefault ? 1 : 0;
  } else {
    return 0;
  }
}

// (b): out = a * linv^T over rows x nb (a at leading dimension lda, linv and
// out at nb), on the body of the planes: the tensor-core body at 2 or 1, else
// the chain body of T
template <typename T>
int product(int planes, const T* a, long long lda, const T* linv, T* out, long long rows,
            long long nb, void* scratch, long long scratch_bytes, cudaStream_t s) {
  if constexpr (std::is_same_v<T, float>) {
    if (planes == 2)
      return launch_tc<T, 2, kTrsm>(nullptr, a, linv, out, rows, nb, nb, 0, lda, nb, nb, scratch,
                                    scratch_bytes, s);
    if (planes == 1)
      return launch_tc<T, 1, kTrsm>(nullptr, a, linv, out, rows, nb, nb, 0, lda, nb, nb, scratch,
                                    scratch_bytes, s);
  }
  (void)planes, (void)scratch, (void)scratch_bytes;
  return launch_chain<T, kTrsm>(nullptr, a, linv, out, rows, nb, nb, 0, lda, nb, nb, 0, s);
}

template <typename T>
int run(const void* panel, void* out, void* linv, void* scratch, long long m, long long nb,
        long long ldp, long long scratch_bytes, int tier, void* stream) {
  if (nb <= 0 || nb > dla::kMaxNb || m <= 0 || m % nb || ldp < nb || tier < dla::kHighest ||
      tier > dla::kDefault)
    return (int)cudaErrorInvalidValue;
  const long long rows = m - nb;
  const int planes = planes_of<T>(tier);
  if (planes && rows > 0 && scratch_bytes < tc_scratch_bytes(planes, rows, nb, nb))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const T* p = (const T*)panel;
  T* o = (T*)out;
  T* x = (T*)linv;
  const TileBody body = planes ? kWgmma : std::is_same_v<T, float> ? kSimt : kDmma;
  int err = dla::launch_diag<T>(tier, p, ldp, o, x, nb, s);  // (a)
  if (err == 0 && rows > 0)  // (b)
    err = product<T>(planes, p + nb * ldp, ldp, x, o + nb * nb, rows, nb, scratch, scratch_bytes,
                     s);
  if (err == 0) ++factor_body_launches[body];
  return err;
}

}  // namespace

// C interface, loaded with ctypes: panel (m x nb, leading dimension ldp),
// out (m x nb, contiguous), linv (nb x nb scratch), scratch (scratch_bytes
// for the tensor-core body's split planes at fp32 high and default; the
// chain bodies read none). Every argument is checked before anything
// launches. Returns the first CUDA error of the launches; 0 means all
// launched. fp64 has one tier: any valid tier code runs it.
extern "C" int dla_panel_factor_f32(const void* panel, void* out, void* linv, void* scratch,
                                    long long m, long long nb, long long ldp,
                                    long long scratch_bytes, int tier, void* stream) {
  return run<float>(panel, out, linv, scratch, m, nb, ldp, scratch_bytes, tier, stream);
}

extern "C" int dla_panel_factor_f64(const void* panel, void* out, void* linv, void* scratch,
                                    long long m, long long nb, long long ldp,
                                    long long scratch_bytes, int tier, void* stream) {
  return run<double>(panel, out, linv, scratch, m, nb, ldp, scratch_bytes, tier, stream);
}

// Calls of dla_panel_factor_<f32|f64> in this process through the body of
// their tier: 0 the scalar body (none), 1 the tensor-core body, 2 the simt
// chain, 3 the dmma chain.
extern "C" long long dla_panel_factor_body_launches(int body) {
  return body >= 0 && body < 4 ? factor_body_launches[body] : 0;
}
