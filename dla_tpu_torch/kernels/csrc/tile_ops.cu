// TRSM, SYRK and GEMM task kernels: one NT-product kernel with three
// epilogues.
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
// the Pallas calls, which alias nothing.
//
// Precision. Each 64 x 64 output block is one nt_block (trailing_block.cuh),
// so the products follow the tiers exactly as the trailing and panel kernels
// do; at high the product is acc + accx. bf16 storage rounds the product to
// bf16 and subtracts in bf16, as .astype(c_ref.dtype) does in the reference.
// m, n and k need not be multiples of 64 (nt_block pads with zeros).
//
// Bound. A 512 x 512 tile is 64 blocks on 132 SMs and a few microseconds of
// scalar FMAs, so at the DAG's tile size a launch is bound by its own
// latency, and a tile-by-tile factorization by the number of launches. At
// sizes that fill the card the kernel is bound like the trailing kernels, by
// scalar FMA throughput; the tensor cores (wgmma) are the next step for all of
// them.

#include "trailing_block.cuh"

namespace {

using dla::BM;
using dla::TM;
using dla::TPB;

enum Epilogue { kTrsm = 0, kSyrk = 1, kGemm = 2 };

__device__ __forceinline__ float narrow(float, float v) { return v; }
__device__ __forceinline__ double narrow(double, double v) { return v; }
__device__ __forceinline__ __nv_bfloat16 narrow(__nv_bfloat16, float v) {
  return __float2bfloat16_rn(v);
}

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
int launch(const T* c, const T* a, const T* b, T* out, long long m, long long n, long long k,
           long long ldc, long long lda, long long ldb, cudaStream_t s) {
  const long long gx = (n + BM - 1) / BM, gy = (m + BM - 1) / BM;
  if (gx > 65535 || gy > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  tile_kernel<T, TIER, EPI><<<grid, TPB, 0, s>>>(c, ldc, a, lda, b, ldb, out, m, n, k);
  return (int)cudaGetLastError();
}

// fp64 and bf16 storage have one tier each (bf16 operands make every tier's
// products exact).
template <typename T, int EPI>
int run(const void* c, const void* a, const void* b, void* out, long long m, long long n,
        long long k, long long ldc, long long lda, long long ldb, int tier, void* stream) {
  if (m <= 0 || n <= 0 || k < 0 || lda < k || ldb < k || (EPI != kTrsm && ldc < n))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const T *cp = (const T*)c, *ap = (const T*)a, *bp = (const T*)b;
  T* o = (T*)out;
  if constexpr (std::is_same_v<T, float>) {
    switch (tier) {
      case dla::kHighest:
        return launch<T, dla::kHighest, EPI>(cp, ap, bp, o, m, n, k, ldc, lda, ldb, s);
      case dla::kHigh:
        return launch<T, dla::kHigh, EPI>(cp, ap, bp, o, m, n, k, ldc, lda, ldb, s);
      case dla::kDefault:
        return launch<T, dla::kDefault, EPI>(cp, ap, bp, o, m, n, k, ldc, lda, ldb, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    (void)tier;
    return launch<T, dla::kHighest, EPI>(cp, ap, bp, o, m, n, k, ldc, lda, ldb, s);
  }
}

}  // namespace

// C interface, loaded with ctypes: dla_<op>_tile_<dtype>(c, a, b, out, m, n, k,
// ldc, lda, ldb, tier, stream). out is (m, n), contiguous; trsm reads no c
// (pass a null pointer), syrk is given b = a. Each returns
// cudaGetLastError() after the launch; 0 means launched.
#define DLA_TILE_OP(op, EPI, suffix, T)                                                     \
  extern "C" int dla_##op##_tile_##suffix(const void* c, const void* a, const void* b,      \
                                          void* out, long long m, long long n, long long k, \
                                          long long ldc, long long lda, long long ldb,      \
                                          int tier, void* stream) {                         \
    return run<T, EPI>(c, a, b, out, m, n, k, ldc, lda, ldb, tier, stream);                 \
  }

#define DLA_TILE_OPS(suffix, T)        \
  DLA_TILE_OP(trsm, kTrsm, suffix, T)  \
  DLA_TILE_OP(syrk, kSyrk, suffix, T)  \
  DLA_TILE_OP(gemm, kGemm, suffix, T)

DLA_TILE_OPS(f32, float)
DLA_TILE_OPS(f64, double)
DLA_TILE_OPS(bf16, __nv_bfloat16)
