// TRSM, SYRK and GEMM task kernels: one NT product with three epilogues, on
// four block bodies.
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
// Three bodies, by tier, the same for all three ops (kernels/tiles.py:
// tile_op_body keeps the same table), all in tile_body.cuh, with out's
// leading dimension n:
// - fp32 high (two bf16 planes) and default (one), and bf16 storage at any
//   tier (one): tile_tc_kernel, the tensor-core pipeline of
//   trailing_wgmma.cuh with two operands (syrk: A's planes serve both), one
//   128 x 128 output tile a block;
// - fp32 highest: tile_simt_kernel, the register-blocked fp32 FMA chain of
//   trailing_chain.cuh (simt_sums), 128- or 64-tiles;
// - fp64: tile_dmma_kernel, the fp64 chain on the fp64 tensor cores
//   (dmma_sums), 64-tiles.
// syrk launches products for the output tiles on and below the diagonal only
// and copies C into the tiles above it, in the same launch (syrk_tile of
// tile_body.cuh). The two chain bodies keep the bits of tile_kernel (one
// 64 x 64 nt_block of scalar FMAs per block, trailing_block.cuh: one fma
// chain per output in ascending k); dla_tile_op_scalar runs tile_kernel on
// any of the three ops for the card tests to hold them to, and
// dla_tile_op_chain_f32 the simt body at a given tile edge, for
// measurements. The launches through each body are counted apart from
// panel_apply.cu's and panel_factor.cu's, which run the same bodies; the two
// test-only entries count nothing, and no launch of the library takes the
// scalar body (its count stays 0; kept at index 0 so that the indices are
// those of earlier builds).
//
// Bound. A 512-tile call moves 3 MB and does 0.27 GFLOP: a few microseconds
// of card time, so at the DAG's tile size a call is bound by its launches
// (split, main kernel) and the host. At m=4096, n=k=2048 (syrk: n=k=2048,
// half the products) the tensor-core body is bound by its bf16 products
// (three passes at high), the chain bodies by fp32 FMA issue and by the
// fp64 tensor cores.

#include "tile_body.cuh"

namespace {

// launches of the three task kernels in this process through each body,
// counted where a launch succeeds
long long tile_body_launches[4] = {0, 0, 0, 0};

int tile_counted(int err, TileBody body) {
  if (err == 0) ++tile_body_launches[body];
  return err;
}

// syrk is square: m = n (and b = a)
bool bad_args(int epi, long long m, long long n, long long k, long long ldc, long long lda,
              long long ldb) {
  return m <= 0 || n <= 0 || k < 0 || lda < k || ldb < k || (epi != kTrsm && ldc < n) ||
         (epi == kSyrk && m != n);
}

// The body follows the storage type and the tier (fp64 and bf16 storage have
// one tier each: bf16 operands make every tier's products exact); a launch
// one body refuses is never retried through another.
template <typename T, int EPI>
int run(const void* c, const void* a, const void* b, void* out, void* scratch, long long m,
        long long n, long long k, long long ldc, long long lda, long long ldb,
        long long scratch_bytes, int tier, void* stream) {
  if (bad_args(EPI, m, n, k, ldc, lda, ldb)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const T *cp = (const T*)c, *ap = (const T*)a, *bp = (const T*)b;
  T* o = (T*)out;
  if constexpr (std::is_same_v<T, double>) {
    (void)tier, (void)scratch, (void)scratch_bytes;
    return tile_counted(launch_chain<T, EPI>(cp, ap, bp, o, m, n, k, ldc, lda, ldb, n, 0, s),
                        kDmma);
  } else if constexpr (std::is_same_v<T, float>) {
    switch (tier) {
      case dla::kHighest:
        return tile_counted(launch_chain<T, EPI>(cp, ap, bp, o, m, n, k, ldc, lda, ldb, n, 0, s),
                            kSimt);
      case dla::kHigh:
        return tile_counted(launch_tc<T, 2, EPI>(cp, ap, bp, o, m, n, k, ldc, lda, ldb, n,
                                                 scratch, scratch_bytes, s),
                            kWgmma);
      case dla::kDefault:
        return tile_counted(launch_tc<T, 1, EPI>(cp, ap, bp, o, m, n, k, ldc, lda, ldb, n,
                                                 scratch, scratch_bytes, s),
                            kWgmma);
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    (void)tier;
    return tile_counted(launch_tc<T, 1, EPI>(cp, ap, bp, o, m, n, k, ldc, lda, ldb, n, scratch,
                                             scratch_bytes, s),
                        kWgmma);
  }
}

// one op of the test-only entries: through tile_kernel (tile 0) or, fp32
// only, through the simt body at the given tile edge; counted nowhere
template <typename T, int EPI>
int run_reference(const void* c, const void* a, const void* b, void* out, long long m,
                  long long n, long long k, long long ldc, long long lda, long long ldb, int tile,
                  void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const T *cp = (const T*)c, *ap = (const T*)a, *bp = (const T*)b;
  T* o = (T*)out;
  if (tile == 0)
    return launch_scalar<T, EPI>(cp, ap, bp, o, m, n, k, ldc, lda, ldb, n, s);
  return launch_chain<T, EPI>(cp, ap, bp, o, m, n, k, ldc, lda, ldb, n, tile, s);
}

template <typename T>
int run_reference(int op, const void* c, const void* a, const void* b, void* out, long long m,
                  long long n, long long k, long long ldc, long long lda, long long ldb, int tile,
                  void* stream) {
  if (op < kTrsm || op > kGemm || bad_args(op, m, n, k, ldc, lda, ldb) ||
      (tile != 0 && !std::is_same_v<T, float>))
    return (int)cudaErrorInvalidValue;
  switch (op) {
    case kTrsm:
      return run_reference<T, kTrsm>(c, a, b, out, m, n, k, ldc, lda, ldb, tile, stream);
    case kSyrk:
      return run_reference<T, kSyrk>(c, a, a, out, m, n, k, ldc, lda, lda, tile, stream);
    default:
      return run_reference<T, kGemm>(c, a, b, out, m, n, k, ldc, lda, ldb, tile, stream);
  }
}

}  // namespace

// C interface, loaded with ctypes: dla_<op>_tile_<dtype>(c, a, b, out, scratch,
// m, n, k, ldc, lda, ldb, scratch_bytes, tier, stream). out is (m, n),
// contiguous; trsm reads no c (pass a null pointer), syrk is given b = a;
// scratch holds scratch_bytes for the split planes of the tensor-core body
// (the other bodies read neither). Each returns the CUDA error of the first
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
// (body = 0: none since syrk left it), the tensor-core body (1), the simt
// chain (2) or the dmma chain (3).
extern "C" long long dla_tile_body_launches(int body) {
  return body >= 0 && body < 4 ? tile_body_launches[body] : 0;
}

// Test-only entries, on no library path: trsm (op 0), syrk (op 1, m = n,
// b read as a) or gemm (op 2) as the task kernels compute them at fp32
// highest and fp64, out (m, n) contiguous.
// dla_tile_op_scalar_<f32|f64> runs tile_kernel (nt_block: the bits the chain
// bodies must keep), dla_tile_op_chain_f32 the simt body at tile edge 64 or
// 128 (fp64 has one edge, the library's). Neither counts a launch. Each
// returns a CUDA error.
#define DLA_TILE_SCALAR(suffix, T)                                                             \
  extern "C" int dla_tile_op_scalar_##suffix(int op, const void* c, const void* a,             \
                                             const void* b, void* out, long long m,            \
                                             long long n, long long k, long long ldc,          \
                                             long long lda, long long ldb, void* stream) {     \
    return run_reference<T>(op, c, a, b, out, m, n, k, ldc, lda, ldb, 0, stream);             \
  }

DLA_TILE_SCALAR(f32, float)
DLA_TILE_SCALAR(f64, double)

extern "C" int dla_tile_op_chain_f32(int op, const void* c, const void* a, const void* b,
                                     void* out, long long m, long long n, long long k,
                                     long long ldc, long long lda, long long ldb, int tile,
                                     void* stream) {
  if (tile == 0) return (int)cudaErrorInvalidValue;
  return run_reference<float>(op, c, a, b, out, m, n, k, ldc, lda, ldb, tile, stream);
}
