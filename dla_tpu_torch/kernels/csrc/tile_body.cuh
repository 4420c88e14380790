// One NT product A * B^T into an output with its own leading dimension, on
// four block bodies, with three epilogues: the products of the task kernels
// trsm_tile, syrk_tile and gemm_tile (tile_ops.cu), of the panel solve
// panel_apply (panel_apply.cu) and of the panel factor's panel (phase (b) of
// panel_factor.cu), which include this header.
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
// The bodies:
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
//   syrk splits A alone (B = A): its scratch holds A's planes only, and the
//   column tile's rows in the tensor map are A's rows.
// - tile_simt_kernel and tile_dmma_kernel (launch_chain), the FMA-chain
//   bodies of trailing_chain.cuh (simt_sums: fp32 highest; dmma_sums: fp64 on
//   the fp64 tensor cores) on a ceil(m/T) x ceil(n/T) grid in the same
//   grouped order (chain_tile; tiles.chain_tile_grid models it). One fma
//   chain per output in ascending k from +0 over 16-column steps, so the
//   scalar body's bits at every T. The simt body takes T = 128 where that
//   grid keeps every SM busy at once, else 64 (at 512^3 a 128 grid has 16
//   blocks, the 64 grid 64); the dmma body takes 64 (its 128-tile main loop
//   serves the trailing kernels only).
// - tile_kernel (launch_scalar), one 64 x 64 nt_block (trailing_block.cuh)
//   per block of a 2-D grid, scalar FMAs at highest (IEEE fp32, fp64): only
//   the test-only entries dla_tile_op_scalar_<f32|f64> (tile_ops.cu), the bit
//   reference of the chain bodies. No library path launches it.
//
// Each including source counts its launches per body with TileBody's
// indices (kScalar stays 0).
//
// syrk's grid. The tensor-core and chain bodies launch as many blocks for
// syrk as for an n x n gemm, g^2 on a g x g grid of output tiles, but only
// the g(g+1)/2 tiles on and below the diagonal form a product (the diagonal
// tiles mask r >= c in the epilogue); the other g(g-1)/2 blocks copy C's
// tile into out and multiply nothing (syrk_tile; tiles.syrk_tile_grid models
// it). out is a new tensor, so the upper tiles must still receive C's bits,
// and one launch writes all of them.
//
// Everything here sits in an anonymous namespace: each source that includes
// the header has its own kernels and its own once-per-device flag of
// allow_smem.

#pragma once

#include "trailing_chain.cuh"

namespace {

enum Epilogue { kTrsm = 0, kSyrk = 1, kGemm = 2 };

// the bodies, by the index of the per-body launch counts
enum TileBody { kScalar = 0, kWgmma = 1, kSimt = 2, kDmma = 3 };

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

template <typename T, int EPI>
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
  dla::nt_block<T>(a + row0 * lda, lda, m - row0, b + col0 * ldb, ldb, n - col0, k, acc);
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
      const A prod = acc[i][j];
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

template <typename T, int EPI>
int launch_scalar(const T* c, const T* a, const T* b, T* out, long long m, long long n,
                  long long k, long long ldc, long long lda, long long ldb, long long ldo,
                  cudaStream_t s) {
  const long long gx = (n + dla::BM - 1) / dla::BM, gy = (m + dla::BM - 1) / dla::BM;
  if (gx > 65535 || gy > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  tile_kernel<T, EPI><<<grid, dla::TPB, 0, s>>>(c, ldc, a, lda, b, ldb, out, ldo, m, n, k);
  return (int)cudaGetLastError();
}

// ---- syrk's triangle ----------------------------------------------------------------

// the largest r with r (r + 1) / 2 <= b (b >= 0)
__device__ __forceinline__ long long tri_root(long long b) {
  long long r = (long long)((sqrt(8.0 * (double)b + 1.0) - 1.0) * 0.5);
  while ((r + 1) * (r + 2) / 2 <= b) ++r;
  while (r * (r + 1) / 2 > b) --r;
  return r;
}

// Block -> (row0, col0) of syrk's g x g grid of T x T output tiles; true for
// a copy block. Blocks 0 .. g(g+1)/2 - 1 take the tiles with row tile >=
// column tile in chain_tile's order: groups of kGroup row tiles, each walked
// column by column, where column first + s of a group holds the group's rows
// s .. rows - 1 (and every row left of the group's diagonal block). The
// other g(g-1)/2 blocks take the tiles above the diagonal, column by column.
template <int T>
__device__ __forceinline__ bool syrk_tile(long long g, long long& row0, long long& col0) {
  constexpr long long kG = dla::chain::kGroup;
  const long long b = blockIdx.x;
  const long long lower = g * (g + 1) / 2;
  if (b >= lower) {
    const long long u = b - lower;
    const long long col = tri_root(u) + 1;  // the col (col - 1) / 2 upper tiles left of it come first
    row0 = (u - col * (col - 1) / 2) * T;
    col0 = col * T;
    return true;
  }
  const long long first = tri_root(b) / kG * kG;  // b's row tile in row order, its group's first
  const long long rows = g - first < kG ? g - first : kG;
  long long left = b - first * (first + 1) / 2;
  if (left < first * rows) {
    row0 = (first + left % rows) * T;
    col0 = left / rows * T;
    return false;
  }
  left -= first * rows;
  long long s = 0;
  for (; left >= rows - s; ++s) left -= rows - s;
  row0 = (first + s + left) * T;
  col0 = (first + s) * T;
  return false;
}

// out = c over the T x T tile at (row0, col0) of an n x n output: a copy
// block of syrk's grid, neighbouring threads on neighbouring columns
template <int T, typename E>
__device__ __forceinline__ void copy_tile(const E* __restrict__ c, long long ldc,
                                          E* __restrict__ out, long long ldo, long long row0,
                                          long long col0, long long n) {
  for (int i = threadIdx.x; i < T * T; i += blockDim.x) {
    const long long r = row0 + i / T, cc = col0 + i % T;
    if (r < n && cc < n) out[r * ldo + cc] = c[r * ldc + cc];
  }
}

// ---- the FMA-chain bodies -----------------------------------------------------------

// out[r, cc] from the product of one element, by epilogue
template <int EPI, typename T>
__device__ __forceinline__ void put(const T* __restrict__ c, long long ldc, T* __restrict__ out,
                                    long long ldo, long long r, long long cc, T prod) {
  if constexpr (EPI == kTrsm) {
    out[r * ldo + cc] = prod;
  } else {
    T v = c[r * ldc + cc];
    if (EPI == kGemm || r >= cc) v = dla::minus(v, prod);
    out[r * ldo + cc] = v;
  }
}

// Block -> (row0, col0) of a gm x gn grid of T x T output tiles: groups of
// kGroup row tiles walked column by column, as block_tile orders 128-tiles
template <int T>
__device__ __forceinline__ void chain_tile(long long gm, long long gn, long long& row0,
                                           long long& col0) {
  using dla::chain::kGroup;
  const long long per_group = kGroup * gn;
  const long long first = (long long)blockIdx.x / per_group * kGroup;
  const long long in_group = (long long)blockIdx.x % per_group;
  const long long rows = gm - first < kGroup ? gm - first : kGroup;
  row0 = (first + in_group % rows) * T;
  col0 = in_group / rows * T;
}

template <int T, bool VEC, int EPI>
__global__ void __launch_bounds__(dla::chain::kSimtThreads,
                                  VEC || T < dla::chain::kTile ? dla::chain::kSimtBlocks : 1)
tile_simt_kernel(const float* __restrict__ c, long long ldc, const float* __restrict__ a,
                 long long lda, const float* __restrict__ b, long long ldb,
                 float* __restrict__ out, long long ldo, long long m, long long n, long long k) {
  using namespace dla::chain;
  long long row0, col0;
  if constexpr (EPI == kSyrk) {
    if (syrk_tile<T>((n + T - 1) / T, row0, col0)) {
      copy_tile<T>(c, ldc, out, ldo, row0, col0, n);
      return;
    }
  } else {
    chain_tile<T>((m + T - 1) / T, (n + T - 1) / T, row0, col0);
  }
  float acc[T / 16][T / 16];
  simt_sums<T, VEC, true>(a, lda, row0, m, b, ldb, col0, n, k, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int j = 0; j < T / 16; ++j) {
    const long long cc = col0 + simt_pos(j, tx);
    if (cc >= n) continue;
#pragma unroll
    for (int i = 0; i < T / 16; ++i) {
      const long long r = row0 + simt_pos(i, ty);
      if (r < m) put<EPI>(c, ldc, out, ldo, r, cc, acc[i][j]);
    }
  }
}

template <int T, bool VEC, int EPI>
__global__ void __launch_bounds__(dla::chain::dmma_threads<T>(), 1)
tile_dmma_kernel(const double* __restrict__ c, long long ldc, const double* __restrict__ a,
                 long long lda, const double* __restrict__ b, long long ldb,
                 double* __restrict__ out, long long ldo, long long m, long long n, long long k) {
  using namespace dla::chain;
  extern __shared__ __align__(16) double ring[];
  long long row0, col0;
  if constexpr (EPI == kSyrk) {
    if (syrk_tile<T>((n + T - 1) / T, row0, col0)) {
      copy_tile<T>(c, ldc, out, ldo, row0, col0, n);
      return;
    }
  } else {
    chain_tile<T>((m + T - 1) / T, (n + T - 1) / T, row0, col0);
  }
  double acc[kMI][kNI][4];
  dmma_sums<T, VEC>(a, lda, row0, m, b, ldb, col0, n, k, ring, acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int wm = warp % dmma_warps<T>(), wn = warp / dmma_warps<T>();
#pragma unroll
  for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
    for (int ec = 0; ec < 2; ++ec) {
      const long long cc = col0 + wn * 8 * kNI + ni * 8 + 2 * q + ec;
      if (cc >= n) continue;
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int er = 0; er < 2; ++er) {
          const long long r = row0 + wm * 16 * kMI + mi * 16 + g + 8 * er;
          if (r < m) put<EPI>(c, ldc, out, ldo, r, cc, acc[mi][ni][2 * er + ec]);
        }
    }
}

// syrk's grid has as many blocks as the rectangular one: g(g+1)/2 products
// and g(g-1)/2 copies of a g x g grid
template <int T, bool VEC, int EPI>
int launch_simt_tile(const float* c, const float* a, const float* b, float* out, long long m,
                     long long n, long long k, long long ldc, long long lda, long long ldb,
                     long long ldo, cudaStream_t s) {
  const long long blocks = ((m + T - 1) / T) * ((n + T - 1) / T);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tile_simt_kernel<T, VEC, EPI><<<(unsigned)blocks, dla::chain::kSimtThreads, 0, s>>>(
      c, ldc, a, lda, b, ldb, out, ldo, m, n, k);
  return (int)cudaGetLastError();
}

template <int T, bool VEC, int EPI>
int launch_dmma_tile(const double* c, const double* a, const double* b, double* out, long long m,
                     long long n, long long k, long long ldc, long long lda, long long ldb,
                     long long ldo, cudaStream_t s) {
  using namespace dla::chain;
  const long long blocks = ((m + T - 1) / T) * ((n + T - 1) / T);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = tile_dmma_kernel<T, VEC, EPI>;
  static std::atomic<unsigned long long> smem_set{0};
  const int err = dla::tc::allow_smem(kernel, dmma_smem<T>(), smem_set);
  if (err != 0) return err;
  kernel<<<(unsigned)blocks, dmma_threads<T>(), dmma_smem<T>(), s>>>(c, ldc, a, lda, b, ldb, out,
                                                                     ldo, m, n, k);
  return (int)cudaGetLastError();
}

// The simt body's tile edge: 128 where its grid at 128 has at least as many
// product blocks (`blocks`: syrk's lower tiles only) as the card runs at once
// (SMs x blocks an SM: 2 on 16-byte rows, else 1), else 64.
// tiles.chain_tile_edge keeps the same rule. The SM count is read once per
// device (devices past 64 read it every time).
inline int chain_edge(long long blocks, int per_sm, int& edge) {
  static std::atomic<int> sms_of[64] = {};
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64) sms = sms_of[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) sms_of[dev].store(sms, std::memory_order_relaxed);
  }
  edge = blocks >= (long long)sms * per_sm ? 128 : 64;
  return 0;
}

// Launch the chain body of the storage type, 128-bit operand loads where A's
// and B's rows start on 16 bytes. float: the simt body at tile edge `tile`
// (64 or 128; 0: chain_edge's choice). double: the dmma body on 64-tiles (4
// warps, two blocks an SM), whatever `tile` is: on the card it beat the
// 128-tile at 256^3 and 512^3 by 2x and at 4096 x 2048 x 2048 by 3%.
template <typename T, int EPI>
int launch_chain(const T* c, const T* a, const T* b, T* out, long long m, long long n,
                 long long k, long long ldc, long long lda, long long ldb, long long ldo,
                 int tile, cudaStream_t s) {
  const bool vec = dla::chain::rows_aligned(a, lda) && dla::chain::rows_aligned(b, ldb);
  if constexpr (std::is_same_v<T, double>) {
    (void)tile;
    return vec ? launch_dmma_tile<64, true, EPI>(c, a, b, out, m, n, k, ldc, lda, ldb, ldo, s)
               : launch_dmma_tile<64, false, EPI>(c, a, b, out, m, n, k, ldc, lda, ldb, ldo, s);
  } else {
    if (tile != 0 && tile != 64 && tile != 128) return (int)cudaErrorInvalidValue;
    if (tile == 0) {
      const long long t = dla::chain::kTile, gm = (m + t - 1) / t, gn = (n + t - 1) / t;
      const long long blocks = EPI == kSyrk ? gm * (gm + 1) / 2 : gm * gn;
      const int err = chain_edge(blocks, vec ? dla::chain::kSimtBlocks : 1, tile);
      if (err != 0) return err;
    }
    if (tile == 128)
      return vec ? launch_simt_tile<128, true, EPI>(c, a, b, out, m, n, k, ldc, lda, ldb, ldo, s)
                 : launch_simt_tile<128, false, EPI>(c, a, b, out, m, n, k, ldc, lda, ldb, ldo, s);
    return vec ? launch_simt_tile<64, true, EPI>(c, a, b, out, m, n, k, ldc, lda, ldb, ldo, s)
               : launch_simt_tile<64, false, EPI>(c, a, b, out, m, n, k, ldc, lda, ldb, ldo, s);
  }
}

// ---- the tensor-core body -----------------------------------------------------------

// out[r, j] = narrow(A B^T) (trsm), minus(c[r, j], A B^T) (gemm), or the
// latter where r >= j and c[r, j] elsewhere (syrk) over one 128 x 128 tile;
// A's planes start at row 0 of the map, B's at PLANES * mpad (syrk: B = A,
// the map holds A's planes only and npad is 0).
template <int PLANES, typename T, int EPI>
__global__ void __launch_bounds__(dla::tc::kThreads, 1)
tile_tc_kernel(const __grid_constant__ CUtensorMap planes, const T* __restrict__ c,
               long long ldc, T* __restrict__ out, long long ldo, long long m, long long n,
               long long mpad, long long npad, int ksteps) {
  using namespace dla::tc;
  long long row0, col0;
  TileRows rows;
  if constexpr (EPI == kSyrk) {
    if (syrk_tile<kBM>(mpad / kBM, row0, col0)) {
      copy_tile<kBM>(c, ldc, out, ldo, row0, col0, n);
      return;
    }
    rows = TileRows{(int)row0, (int)mpad, (int)col0, (int)mpad};
  } else {
    block_tile(mpad / kBM, npad / kBM, row0, col0);
    rows = TileRows{(int)row0, (int)mpad, (int)(PLANES * mpad + col0), (int)npad};
  }

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // 128-byte swizzle wants 1024-byte tiles
  float sum[64];
  float accx[PLANES == 2 ? 64 : 1];
  mainloop<PLANES>(&planes, rows, ksteps, base, sum, accx);
  float* tile = reinterpret_cast<float*>(smem_raw + (base - raw));
  stage_sums<PLANES>(tile, sum, accx);

  // each thread one column, every other row; gemm's and syrk's loads of c batched ahead of
  // the stores
  const int t = threadIdx.x;
  const int j = t % kBM;
  const long long gc = col0 + j;
  if (gc >= n) return;
  for (int i0 = t / kBM; i0 < kBM; i0 += 2 * kBatch) {
    if constexpr (EPI != kTrsm) {
      T old[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const long long r = row0 + i0 + 2 * u;
        if (r < m) old[u] = c[r * ldc + gc];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const long long r = row0 + i0 + 2 * u;
        if (r < m)
          out[r * ldo + gc] = EPI == kGemm || r >= gc
                                  ? dla::minus(old[u], tile[(i0 + 2 * u) * kLd + j])
                                  : old[u];
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
// (syrk: n = 0, A's planes only)
inline long long tc_scratch_bytes(int planes, long long m, long long n, long long k) {
  using namespace dla::tc;
  const long long mpad = (m + kBM - 1) / kBM * kBM, npad = (n + kBM - 1) / kBM * kBM;
  const long long kpad = k > kBK ? (k + kBK - 1) / kBK * kBK : kBK;  // no empty map at k < 64
  return planes * (mpad + npad) * kpad * 2;
}

// split A and B (syrk: A alone) into the scratch, then the main kernel; both on s
template <typename T, int PLANES, int EPI>
int launch_tc(const T* c, const T* a, const T* b, T* out, long long m, long long n, long long k,
              long long ldc, long long lda, long long ldb, long long ldo, void* scratch,
              long long scratch_bytes, cudaStream_t s) {
  using namespace dla::tc;
  constexpr bool kSelf = EPI == kSyrk;  // B = A: A's planes serve both operands
  const long long nb_rows = kSelf ? 0 : n;  // B's rows in the scratch
  const long long mpad = (m + kBM - 1) / kBM * kBM, npad = (nb_rows + kBM - 1) / kBM * kBM;
  const long long kpad = k > kBK ? (k + kBK - 1) / kBK * kBK : kBK;  // no empty map at k < 64
  const long long rows = PLANES * (mpad + npad);
  const long long blocks = kSelf ? (mpad / kBM) * (mpad / kBM) : (mpad / kBM) * (npad / kBM);
  if (scratch_bytes < tc_scratch_bytes(PLANES, m, nb_rows, k) || blocks > 0x7fffffffLL ||
      rows > 0x7fffffffLL || kpad / kBK > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  int err = encode_bf16(&map, scratch, rows, kpad, kpad);
  if (err != 0) return err;

  split_kernel<T, PLANES><<<(unsigned)(mpad + npad), 256, 0, s>>>(
      a, m, lda, mpad, kSelf ? nullptr : b, nb_rows, ldb, npad, k, (__nv_bfloat16*)scratch, kpad);
  err = (int)cudaGetLastError();
  if (err != 0) return err;

  auto kernel = tile_tc_kernel<PLANES, T, EPI>;
  constexpr int smem = smem_bytes<PLANES>();
  static std::atomic<unsigned long long> smem_set{0};
  err = allow_smem(kernel, smem, smem_set);
  if (err != 0) return err;
  kernel<<<(unsigned)blocks, kThreads, smem, s>>>(map, c, ldc, out, ldo, m, n, mpad, npad,
                                                  (int)(kpad / kBK));
  return (int)cudaGetLastError();
}

}  // namespace
