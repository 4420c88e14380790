// One NT product A * B^T into an output with its own leading dimension, on
// two block bodies, with two epilogues: the products of the task kernels
// trsm_tile, syrk_tile and gemm_tile (tile_ops.cu) and of the panel solve
// panel_apply (panel_apply.cu), which include this header.
//
// What it computes. A is (m, k), B is (n, k), both row-major with their own
// leading dimensions; out (m, n) has leading dimension ldo:
//   trsm   out = P                  (the product with an inverse)
//   syrk   out = C - P where r >= c, else C (C passes through bit for bit)
//   gemm   out = C - P              (a correction)
// with P = A * B^T and C (m, n) at leading dimension ldc. out is never an
// input. bf16 storage rounds the product to bf16 (and subtracts in bf16), as
// .astype(c_ref.dtype) does in the reference. m, n and k need not be
// multiples of anything, and no pointer or leading dimension need be aligned.
//
// The two bodies:
// - tile_tc_kernel (launch_tc), the tensor-core pipeline of trailing_wgmma.cuh
//   with two operands, for bf16 products (fp32 high: two bf16 planes,
//   default and bf16 storage: one). The split kernel writes A's planes and
//   then B's into one scratch (rows padded to 128, k to 64, at least 64,
//   zeros in the padding), one tensor map covers it, and each block takes
//   one 128 x 128 output tile on a ceil(m/128) x ceil(n/128) grid, in the
//   trailing body's grouped order; its epilogue writes out (and reads C) one
//   thread per column, coalesced. Its sums are not the scalar body's bits:
//   wgmma adds in another order and does not round to nearest between
//   promotions (every 256 columns of k), within 1e-5 of max|a_i| * max|b_j|.
// - tile_kernel (launch_scalar), one 64 x 64 nt_block (trailing_block.cuh)
//   per block of a 2-D grid, scalar FMAs: every tier, for fp32 highest, fp64
//   and the products the caller keeps off the tensor cores.
//
// Everything here sits in an anonymous namespace: each source that includes
// the header has its own kernels and its own once-per-device flag of
// allow_smem.

#pragma once

#include "trailing_wgmma.cuh"

namespace {

enum Epilogue { kTrsm = 0, kSyrk = 1, kGemm = 2 };

// the product in the storage type: bf16 storage rounds it, fp32 and fp64 keep it
template <typename T, typename A>
__device__ __forceinline__ T narrow(A v) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return __float2bfloat16_rn(v);
  } else {
    return v;
  }
}

// ---- the scalar body ----------------------------------------------------------------

template <typename T, int TIER, int EPI>
__global__ void __launch_bounds__(dla::TPB)
tile_kernel(const T* __restrict__ c, long long ldc, const T* __restrict__ a, long long lda,
            const T* __restrict__ b, long long ldb, T* __restrict__ out, long long ldo,
            long long m, long long n, long long k) {
  using dla::BM;
  using dla::TM;
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
        out[r * ldo + cc] = narrow<T>(prod);
      } else {
        T v = c[r * ldc + cc];
        if (EPI == kGemm || r >= cc) dla::subtract(&v, prod);
        out[r * ldo + cc] = v;
      }
    }
  }
}

template <typename T, int TIER, int EPI>
int launch_scalar(const T* c, const T* a, const T* b, T* out, long long m, long long n,
                  long long k, long long ldc, long long lda, long long ldb, long long ldo,
                  cudaStream_t s) {
  const long long gx = (n + dla::BM - 1) / dla::BM, gy = (m + dla::BM - 1) / dla::BM;
  if (gx > 65535 || gy > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  tile_kernel<T, TIER, EPI><<<grid, dla::TPB, 0, s>>>(c, ldc, a, lda, b, ldb, out, ldo, m, n, k);
  return (int)cudaGetLastError();
}

// ---- the tensor-core body -----------------------------------------------------------

// out[r, j] = narrow(A B^T) (trsm) or minus(c[r, j], A B^T) (gemm) over one
// 128 x 128 tile; A's planes start at row 0 of the map, B's at PLANES * mpad.
template <int PLANES, typename T, int EPI>
__global__ void __launch_bounds__(dla::tc::kThreads, 1)
tile_tc_kernel(const __grid_constant__ CUtensorMap planes, const T* __restrict__ c,
               long long ldc, T* __restrict__ out, long long ldo, long long m, long long n,
               long long mpad, long long npad, int ksteps) {
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
        if (r < m) out[r * ldo + gc] = dla::minus(old[u], tile[(i0 + 2 * u) * kLd + j]);
      }
    } else {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const long long r = row0 + i0 + 2 * u;
        if (r < m) out[r * ldo + gc] = narrow<T>(tile[(i0 + 2 * u) * kLd + j]);
      }
    }
  }
}

// the split scratch's bytes for one product: PLANES x (mpad + npad) rows of kpad bf16
inline long long tc_scratch_bytes(int planes, long long m, long long n, long long k) {
  using namespace dla::tc;
  const long long mpad = (m + kBM - 1) / kBM * kBM, npad = (n + kBM - 1) / kBM * kBM;
  const long long kpad = k > kBK ? (k + kBK - 1) / kBK * kBK : kBK;  // no empty map at k < 64
  return planes * (mpad + npad) * kpad * 2;
}

// split A and B into the scratch, then the main kernel; both on s
template <typename T, int PLANES, int EPI>
int launch_tc(const T* c, const T* a, const T* b, T* out, long long m, long long n, long long k,
              long long ldc, long long lda, long long ldb, long long ldo, void* scratch,
              long long scratch_bytes, cudaStream_t s) {
  using namespace dla::tc;
  const long long mpad = (m + kBM - 1) / kBM * kBM, npad = (n + kBM - 1) / kBM * kBM;
  const long long kpad = k > kBK ? (k + kBK - 1) / kBK * kBK : kBK;  // no empty map at k < 64
  const long long rows = PLANES * (mpad + npad);
  if (scratch_bytes < tc_scratch_bytes(PLANES, m, n, k) ||
      (mpad / kBM) * (npad / kBM) > 0x7fffffffLL ||
      rows > 0x7fffffffLL || kpad / kBK > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  int err = encode_bf16(&map, scratch, rows, kpad, kpad);
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
      map, c, ldc, out, ldo, m, n, mpad, npad, (int)(kpad / kBK));
  return (int)cudaGetLastError();
}

}  // namespace
