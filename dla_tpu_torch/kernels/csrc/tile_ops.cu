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
// Two bodies, by tier (kernels/tiles.py:tile_op_planes keeps the same table):
// - trsm and gemm at fp32 high (two bf16 planes) and default (one), and bf16
//   storage at any tier (one): the tensor-core pipeline of
//   trailing_wgmma.cuh with two operands. The split kernel writes A's planes
//   and then B's into one scratch (rows padded to 128, k to 64, at least 64,
//   zeros in the padding), one tensor map covers it, and tile_tc_kernel takes
//   one 128 x 128 output tile per block on a ceil(m/128) x ceil(n/128) grid,
//   in the trailing body's grouped order; its epilogue writes out (and reads
//   c) one thread per column, coalesced. Its sums are not the scalar body's
//   bits: wgmma adds in another order and does not round to nearest between
//   promotions (every 256 columns of k), within 1e-5 of max|a_i| * max|b_j|.
// - syrk at every tier, and fp32 highest and fp64: tile_kernel, one 64 x 64
//   nt_block (trailing_block.cuh) per block, scalar FMAs.
//
// Bound. A 512-tile call moves 3 MB and does 0.27 GFLOP: a few microseconds
// of card time, so at the DAG's tile size a call is bound by its launches
// (split, main kernel) and the host. At m=4096, n=k=2048 the tensor-core
// body is bound by its bf16 products (three passes at high), the scalar body
// by FMA issue.

#include "trailing_wgmma.cuh"

namespace {

using dla::BM;
using dla::TM;
using dla::TPB;

enum Epilogue { kTrsm = 0, kSyrk = 1, kGemm = 2 };

// launches of the three task kernels in this process through each body
// (dla::kScalarBody, dla::kTensorCoreBody), counted where a launch succeeds
long long tile_body_launches[2] = {0, 0};

int tile_counted(int err, dla::Body body) {
  if (err == 0) ++tile_body_launches[body];
  return err;
}

__device__ __forceinline__ float narrow(float, float v) { return v; }
__device__ __forceinline__ double narrow(double, double v) { return v; }
__device__ __forceinline__ __nv_bfloat16 narrow(__nv_bfloat16, float v) {
  return __float2bfloat16_rn(v);
}

// ---- the scalar body ----------------------------------------------------------------

template <typename T, int TIER, int EPI>
__global__ void __launch_bounds__(TPB)
tile_kernel(const T* __restrict__ c, long long ldc, const T* __restrict__ a, long long lda,
            const T* __restrict__ b, long long ldb, T* __restrict__ out, long long m,
            long long n, long long k) {
  using A = typename dla::AccOf<T>::type;
  const long long row0 = (long long)blockIdx.y * BM;
  const long long col0 = (long long)blockIdx.x * BM;
  A acc[TM][TM];
  A accx[TM][TM];  // high only: the two cross terms hi*lo + lo*hi
  dla::nt_block<T, TIER>(a + row0 * lda, lda, m - row0, b + col0 * ldb, ldb, n - col0, k, acc,
                         accx);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long r = row0 + ty + 16 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const long long cc = col0 + tx + 16 * j;
      if (cc >= n) continue;
      const A prod = TIER == dla::kHigh ? acc[i][j] + accx[i][j] : acc[i][j];
      if constexpr (EPI == kTrsm) {
        out[r * n + cc] = narrow(T(), prod);
      } else {
        T v = c[r * ldc + cc];
        if (EPI == kGemm || r >= cc) dla::subtract(&v, prod);
        out[r * n + cc] = v;
      }
    }
  }
}

template <typename T, int TIER, int EPI>
int launch_scalar(const T* c, const T* a, const T* b, T* out, long long m, long long n,
                  long long k, long long ldc, long long lda, long long ldb, cudaStream_t s) {
  const long long gx = (n + BM - 1) / BM, gy = (m + BM - 1) / BM;
  if (gx > 65535 || gy > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  tile_kernel<T, TIER, EPI><<<grid, TPB, 0, s>>>(c, ldc, a, lda, b, ldb, out, m, n, k);
  return (int)cudaGetLastError();
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
        return launch_scalar<T, dla::kHighest, EPI>(c, a, b, out, m, n, k, ldc, lda, ldb, s);
      case dla::kHigh:
        return launch_scalar<T, dla::kHigh, EPI>(c, a, b, out, m, n, k, ldc, lda, ldb, s);
      case dla::kDefault:
        return launch_scalar<T, dla::kDefault, EPI>(c, a, b, out, m, n, k, ldc, lda, ldb, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    (void)tier;
    return launch_scalar<T, dla::kHighest, EPI>(c, a, b, out, m, n, k, ldc, lda, ldb, s);
  }
}

// ---- the tensor-core body -----------------------------------------------------------

// out[r, j] = narrow(A B^T) (trsm) or minus(c[r, j], A B^T) (gemm) over one
// 128 x 128 tile; A's planes start at row 0 of the map, B's at PLANES * mpad.
template <int PLANES, typename T, int EPI>
__global__ void __launch_bounds__(dla::tc::kThreads, 1)
tile_tc_kernel(const __grid_constant__ CUtensorMap planes, const T* __restrict__ c,
               long long ldc, T* __restrict__ out, long long m, long long n, long long mpad,
               long long npad, int ksteps) {
  using namespace dla::tc;
  long long row0, col0;
  block_tile(mpad / kBM, npad / kBM, row0, col0);

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // 128-byte swizzle wants 1024-byte tiles
  float sum[64];
  float accx[PLANES == 2 ? 64 : 1];
  mainloop<PLANES>(&planes,
                   TileRows{(int)row0, (int)mpad, (int)(PLANES * mpad + col0), (int)npad},
                   ksteps, base, sum, accx);
  float* tile = reinterpret_cast<float*>(smem_raw + (base - raw));
  stage_sums<PLANES>(tile, sum, accx);

  // each thread one column, every other row; gemm's loads of c batched ahead of the stores
  const int t = threadIdx.x;
  const int j = t % kBM;
  const long long gc = col0 + j;
  if (gc >= n) return;
  for (int i0 = t / kBM; i0 < kBM; i0 += 2 * kBatch) {
    if constexpr (EPI == kGemm) {
      T old[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const long long r = row0 + i0 + 2 * u;
        if (r < m) old[u] = c[r * ldc + gc];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const long long r = row0 + i0 + 2 * u;
        if (r < m) out[r * n + gc] = dla::minus(old[u], tile[(i0 + 2 * u) * kLd + j]);
      }
    } else {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const long long r = row0 + i0 + 2 * u;
        if (r < m) out[r * n + gc] = narrow(T(), tile[(i0 + 2 * u) * kLd + j]);
      }
    }
  }
}

// split A and B into the scratch, then the main kernel; both on s
template <typename T, int PLANES, int EPI>
int launch_tc(const T* c, const T* a, const T* b, T* out, long long m, long long n, long long k,
              long long ldc, long long lda, long long ldb, void* scratch,
              long long scratch_bytes, cudaStream_t s) {
  using namespace dla::tc;
  const long long mpad = (m + kBM - 1) / kBM * kBM, npad = (n + kBM - 1) / kBM * kBM;
  const long long kpad = k > kBK ? (k + kBK - 1) / kBK * kBK : kBK;  // no empty map at k < 64
  const long long rows = PLANES * (mpad + npad);
  if (scratch_bytes < rows * kpad * 2 || (mpad / kBM) * (npad / kBM) > 0x7fffffffLL ||
      rows > 0x7fffffffLL || kpad / kBK > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  int err = encode_planes(&map, scratch, rows, kpad);
  if (err != 0) return err;

  split_kernel<T, PLANES><<<(unsigned)(mpad + npad), 256, 0, s>>>(
      a, m, lda, mpad, b, n, ldb, npad, k, (__nv_bfloat16*)scratch, kpad);
  err = (int)cudaGetLastError();
  if (err != 0) return err;

  auto kernel = tile_tc_kernel<PLANES, T, EPI>;
  constexpr int smem = smem_bytes<PLANES>();
  static std::atomic<unsigned long long> smem_set{0};
  err = allow_smem(kernel, smem, smem_set);
  if (err != 0) return err;
  kernel<<<(unsigned)((mpad / kBM) * (npad / kBM)), kThreads, smem, s>>>(
      map, c, ldc, out, m, n, mpad, npad, (int)(kpad / kBK));
  return (int)cudaGetLastError();
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
                                                            ldb, s),
                       dla::kScalarBody);
      case dla::kHigh:
        return tile_counted(launch_tc<T, 2, EPI>(cp, ap, bp, o, m, n, k, ldc, lda, ldb, scratch,
                                            scratch_bytes, s),
                       dla::kTensorCoreBody);
      case dla::kDefault:
        return tile_counted(launch_tc<T, 1, EPI>(cp, ap, bp, o, m, n, k, ldc, lda, ldb, scratch,
                                            scratch_bytes, s),
                       dla::kTensorCoreBody);
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    (void)tier;
    return tile_counted(launch_tc<T, 1, EPI>(cp, ap, bp, o, m, n, k, ldc, lda, ldb, scratch,
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
