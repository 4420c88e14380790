// TRSM, SYRK and GEMM task kernels: one NT product with three epilogues, on
// two block bodies.
//
// Replaces dla_tpu/kernels/pallas_tiles.py:trsm_tile, syrk_tile and gemm_tile
// (bodies _trsm_kernel, _syrk_kernel, _gemm_kernel), the three product tasks
// of the reference's tile DAG.
//
// What it computes. With P = A * B^T (A is (m, k), B is (n, k), both
// row-major with their own leading dimensions), out (m, n), contiguous, is
//   trsm   P                        A = the right-hand side, B = inv(L)
//   syrk   C - P where r >= c,      A = B; above the diagonal C passes
//          else C                   through bit for bit
//   gemm   C - P
// Not in place: out is a tensor of its own and the inputs are only read, as
// the Pallas calls, which alias nothing. bf16 storage rounds the product to
// bf16 (and subtracts in bf16), as .astype(c_ref.dtype) does in the
// reference. m, n and k need not be multiples of anything.
//
// Two bodies, by tier (kernels/tiles.py:tile_op_planes keeps the same table),
// both in tile_body.cuh, with out's leading dimension n:
// - trsm and gemm at fp32 high (two bf16 planes) and default (one), and bf16
//   storage at any tier (one): tile_tc_kernel, the tensor-core pipeline of
//   trailing_wgmma.cuh with two operands, one 128 x 128 output tile a block;
// - syrk at every tier, and fp32 highest and fp64: tile_kernel, one 64 x 64
//   nt_block (trailing_block.cuh) per block, scalar FMAs.
// The launches through each body are counted apart from panel_apply.cu's,
// which runs the same bodies.
//
// Bound. A 512-tile call moves 3 MB and does 0.27 GFLOP: a few microseconds
// of card time, so at the DAG's tile size a call is bound by its launches
// (split, main kernel) and the host. At m=4096, n=k=2048 the tensor-core
// body is bound by its bf16 products (three passes at high), the scalar body
// by FMA issue.

#include "tile_body.cuh"

namespace {

// launches of the three task kernels in this process through each body
// (dla::kScalarBody, dla::kTensorCoreBody), counted where a launch succeeds
long long tile_body_launches[2] = {0, 0};

int tile_counted(int err, dla::Body body) {
  if (err == 0) ++tile_body_launches[body];
  return err;
}

// fp64 and bf16 storage have one tier each (bf16 operands make every tier's
// products exact).
template <typename T, int EPI>
int run_scalar(const T* c, const T* a, const T* b, T* out, long long m, long long n,
               long long k, long long ldc, long long lda, long long ldb, int tier,
               cudaStream_t s) {
  if constexpr (std::is_same_v<T, float>) {
    switch (tier) {
      case dla::kHighest:
        return launch_scalar<T, dla::kHighest, EPI>(c, a, b, out, m, n, k, ldc, lda, ldb, n, s);
      case dla::kHigh:
        return launch_scalar<T, dla::kHigh, EPI>(c, a, b, out, m, n, k, ldc, lda, ldb, n, s);
      case dla::kDefault:
        return launch_scalar<T, dla::kDefault, EPI>(c, a, b, out, m, n, k, ldc, lda, ldb, n, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    (void)tier;
    return launch_scalar<T, dla::kHighest, EPI>(c, a, b, out, m, n, k, ldc, lda, ldb, n, s);
  }
}

// The body follows the op, the storage type and the tier; a launch one body
// refuses is never retried through the other.
template <typename T, int EPI>
int run(const void* c, const void* a, const void* b, void* out, void* scratch, long long m,
        long long n, long long k, long long ldc, long long lda, long long ldb,
        long long scratch_bytes, int tier, void* stream) {
  if (m <= 0 || n <= 0 || k < 0 || lda < k || ldb < k || (EPI != kTrsm && ldc < n))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const T *cp = (const T*)c, *ap = (const T*)a, *bp = (const T*)b;
  T* o = (T*)out;
  if constexpr (EPI == kSyrk || std::is_same_v<T, double>) {
    (void)scratch, (void)scratch_bytes;
    return tile_counted(run_scalar<T, EPI>(cp, ap, bp, o, m, n, k, ldc, lda, ldb, tier, s),
                   dla::kScalarBody);
  } else if constexpr (std::is_same_v<T, float>) {
    switch (tier) {
      case dla::kHighest:
        return tile_counted(launch_scalar<T, dla::kHighest, EPI>(cp, ap, bp, o, m, n, k, ldc, lda,
                                                            ldb, n, s),
                       dla::kScalarBody);
      case dla::kHigh:
        return tile_counted(launch_tc<T, 2, EPI>(cp, ap, bp, o, m, n, k, ldc, lda, ldb, n,
                                            scratch, scratch_bytes, s),
                       dla::kTensorCoreBody);
      case dla::kDefault:
        return tile_counted(launch_tc<T, 1, EPI>(cp, ap, bp, o, m, n, k, ldc, lda, ldb, n,
                                            scratch, scratch_bytes, s),
                       dla::kTensorCoreBody);
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    (void)tier;
    return tile_counted(launch_tc<T, 1, EPI>(cp, ap, bp, o, m, n, k, ldc, lda, ldb, n, scratch,
                                        scratch_bytes, s),
                   dla::kTensorCoreBody);
  }
}

}  // namespace

// C interface, loaded with ctypes: dla_<op>_tile_<dtype>(c, a, b, out, scratch,
// m, n, k, ldc, lda, ldb, scratch_bytes, tier, stream). out is (m, n),
// contiguous; trsm reads no c (pass a null pointer), syrk is given b = a;
// scratch holds scratch_bytes for the split planes of the tensor-core body
// (the scalar body reads neither). Each returns the CUDA error of the first
// step that failed; 0 means launched.
#define DLA_TILE_OP(op, EPI, suffix, T)                                                       \
  extern "C" int dla_##op##_tile_##suffix(const void* c, const void* a, const void* b,        \
                                          void* out, void* scratch, long long m, long long n, \
                                          long long k, long long ldc, long long lda,          \
                                          long long ldb, long long scratch_bytes, int tier,   \
                                          void* stream) {                                     \
    return run<T, EPI>(c, a, b, out, scratch, m, n, k, ldc, lda, ldb, scratch_bytes, tier,    \
                       stream);                                                               \
  }

#define DLA_TILE_OPS(suffix, T)        \
  DLA_TILE_OP(trsm, kTrsm, suffix, T)  \
  DLA_TILE_OP(syrk, kSyrk, suffix, T)  \
  DLA_TILE_OP(gemm, kGemm, suffix, T)

DLA_TILE_OPS(f32, float)
DLA_TILE_OPS(f64, double)
DLA_TILE_OPS(bf16, __nv_bfloat16)

// Launches of the three task kernels in this process through the scalar body
// (body = 0) or the tensor-core body (1).
extern "C" long long dla_tile_body_launches(int body) { return tile_body_launches[body != 0]; }
