// The tensor-core block body of the two trailing-update kernels: C <- C -
// P * P^T over the lower tb-tile pairs of a square window, in place (the
// launch that picks a body is launch_trailing, trailing_chain.cuh). Its
// pipeline (split, mainloop, stage_sums) is
// also the body of the task kernels trsm_tile and gemm_tile (tile_ops.cu),
// which multiply two operands, A * B^T, into a new tensor; its parts (the
// TMA loads, mbarriers, wgmma128, block_tile, encode_bf16) also build the
// df64 body (trailing_df64.cuh).
//
// What it computes is what the FMA-chain bodies (trailing_chain.cuh) compute:
// every element with r/tb >= c/tb (whole diagonal tiles) becomes
// C[r, c] - sum_k P[r, k] * P[c, k], every other element is never written,
// and the address of element (r, c) comes from the kernel's address functor
// (trailing_lower.cu: the dense window; trailing_packed.cu: the packed
// triangle). This body takes the tiers whose products are bf16 products:
//   float, high      bf16x3: hi = bf16(x), lo = bf16(x - hi); the result is
//                    acc + accx with acc = hi*hi^T and accx = hi*lo^T +
//                    lo*hi^T, two accumulators kept apart as in the
//                    reference's _dot_nt (pallas_tiles.py:68-88);
//   float, default   bf16(a) * bf16(b), fp32 accumulation;
//   bf16 storage     bf16 operands, fp32 accumulation, and the epilogue
//                    bf16(c - bf16(acc)).
// float highest and double take the FMA-chain bodies of trailing_chain.cuh:
// bf16 products give neither IEEE fp32 products nor the fp64 the reference
// asks for.
//
// Design.
// - Split once. A small kernel writes P (w x nb, leading dimension ldp) into
//   bf16 scratch that the wrapper allocates (the task kernels: A's planes,
//   then B's, in one launch and one tensor map): planes x wpad x kpad, one plane
//   (bf16 of x) or two (hi, lo), rows padded with zeros to a multiple of the
//   128-row tile and k to a multiple of 64. Every TMA box is then aligned and
//   full, a ragged w, nb or ldp needs no path of its own, and each P element
//   is split once instead of once per output block.
// - Main kernel: one 128 x 128 output tile per block, two warpgroups (256
//   threads, so that a thread may hold 255 registers: at high it keeps
//   3 x 64 fp32 sums; past 256 threads ptxas caps a thread at 168 and
//   spills them). Thread 0 also issues the TMA loads of the row tile
//   P[row0:+128, k:+64] and the column tile P[col0:+128, k:+64] of each
//   plane, 128-byte swizzled, into a ring of stages guarded by mbarriers (3
//   stages of 64 KB at high, 6 of 32 KB otherwise): S stages at the start,
//   then each stage again as soon as every warp has released it. Each
//   warpgroup runs wgmma.m64n128k16 on 64 rows of the tile, both operands
//   K-major, the fp32 sums in registers.
// - Promotion. The tensor cores' fp32 accumulation does not round to
//   nearest at every add: summed over k = 4096 in the tensor cores alone,
//   the largest sums drifted about 100 ulp from the plain version (4.9e-2,
//   1.1e-5 of max |P*P^T|, past the card tests' tolerance; measured on an
//   H100). So the products go into the accumulator fresh every kPromote
//   stages (256 columns of k), and each such partial sum is added into a
//   second fp32 register sum with round-to-nearest adds (2.7e-2 at k = 4096,
//   about the plain version's own rounding). At high only hi*hi is
//   promoted: the cross terms are 2^-8 of it.
// - Epilogue: the sums go through shared memory, so that each thread then
//   owns one column: one address-functor column part and one mask bound
//   (r >= (c/tb)*tb) per thread, 32 neighbouring columns per warp (coalesced),
//   loads batched ahead of the stores. Offsets and the mask are 64-bit.
// - Blocks are numbered in groups of 8 row tiles walked column by column, so
//   that the blocks in flight share their operand tiles in L2; a block whose
//   rows all lie above the tb-diagonal returns at once.
//
// Bound. At the paths' shapes (nb = 1024 or 4096 columns of k) the bf16
// products bind: 2*nb operations per element and pass against one read and
// one write of C. The non-persistent grid leaves each block's epilogue and
// pipeline fill unoverlapped; a persistent tile scheduler is the next step.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "trailing_block.cuh"

namespace dla {
namespace tc {

constexpr int kBM = 128;                     // output tile rows = cols
constexpr int kBK = 64;                      // k per stage: one 128-byte swizzle row of bf16
constexpr int kConsumerWarps = 8;            // two warpgroups; thread 0 also loads
constexpr int kThreads = 32 * kConsumerWarps;
constexpr int kTileBytes = kBM * kBK * 2;    // one operand tile of one plane, 16 KB
constexpr int kRingBytes = 192 * 1024;       // the ring of stages
constexpr int kLd = kBM + 8;                 // fp32 row stride of the epilogue tile
constexpr int kGroup = 8;                    // row tiles per group of the block order
constexpr int kBatch = 16;                   // epilogue loads issued ahead of their stores
constexpr int kPromote = 4;                  // stages (4 x 64 columns of k) per promotion

template <int PLANES> __host__ __device__ constexpr int stages() {
  return kRingBytes / (2 * PLANES * kTileBytes);
}
template <int PLANES> __host__ __device__ constexpr int smem_bytes() {
  return kRingBytes + 1024 /* alignment slack */ + 2 * stages<PLANES>() * 8 /* mbarriers */;
}
static_assert(kBM * kLd * 4 <= kRingBytes, "the epilogue tile reuses the ring");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// wait for the phase of parity `parity` to complete; a wait past ten seconds
// (a load that never lands) traps: a fault, never a hang
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = now_ns();
  while (!mbar_try_wait(bar, parity))
    if (now_ns() - t0 > 10000000000ull) __trap();
}

// box {kBK, kBM} at (k, row) of the planes' tensor map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int k, int row,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major, 128-byte swizzled bf16 tile:
// 8-row groups 1024 bytes apart (SBO), the leading offset unused (1).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from touching the accumulators while wgmma owns them
__device__ __forceinline__ void fence_operand(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] = a[64 x 16] * b[128 x 16]^T + (accumulate ? d : 0), both
// operands K-major in shared memory
__device__ __forceinline__ void wgmma128(float (&d)[64], uint64_t a, uint64_t b,
                                         uint32_t accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Operands A (m x k, leading dimension lda) and B (n x k, ldb) into the
// planes scratch, bf16, zero padded: A's planes x mpad x kpad, then B's
// planes x npad x kpad. Plane 0 is bf16(x); at two planes plane 1 is
// bf16(x - plane 0). One block per row of either operand's plane 0; the
// trailing kernels split P alone (b null, n = npad = 0).
template <typename T, int PLANES>
__global__ void split_kernel(const T* __restrict__ a, long long m, long long lda, long long mpad,
                             const T* __restrict__ b, long long n, long long ldb, long long npad,
                             long long k, __nv_bfloat16* __restrict__ out, long long kpad) {
  const bool is_a = (long long)blockIdx.x < mpad;
  const long long r = is_a ? (long long)blockIdx.x : (long long)blockIdx.x - mpad;
  const T* src = is_a ? a : b;
  const long long rows = is_a ? m : n, ld = is_a ? lda : ldb;
  const long long plane = (is_a ? mpad : npad) * kpad;  // to the row's lo plane
  __nv_bfloat16* row = out + (is_a ? r : PLANES * mpad + r) * kpad;
  for (long long kk = threadIdx.x; kk < kpad; kk += blockDim.x) {
    const float x = (r < rows && kk < k) ? widen(src[r * ld + kk]) : 0.0f;
    const __nv_bfloat16 hi = __float2bfloat16_rn(x);
    row[kk] = hi;
    if constexpr (PLANES == 2) row[plane + kk] = __float2bfloat16_rn(x - __bfloat162float(hi));
  }
}

// Block -> (row tile, column tile) of a gm x gn grid of output tiles: groups
// of kGroup row tiles, walked column by column, so that the blocks in flight
// share their operand tiles in L2.
__device__ __forceinline__ void block_tile(long long gm, long long gn, long long& row0,
                                           long long& col0) {
  const long long per_group = kGroup * gn;
  const long long first = (long long)blockIdx.x / per_group * kGroup;
  const long long in_group = (long long)blockIdx.x % per_group;
  const long long rows_in_group = min(gm - first, (long long)kGroup);
  row0 = (first + in_group % rows_in_group) * kBM;
  col0 = in_group / rows_in_group * kBM;
}

// Where a block's two operand tiles start, in rows of the planes' tensor
// map: plane pl of the row tile at a + pl * a_plane, plane pl of the column
// tile at b + pl * b_plane.
struct TileRows {
  int a, a_plane, b, b_plane;
};

// The pipeline of one 128 x 128 output tile: the TMA ring, its mbarriers,
// the wgmma k-loop over ksteps stages and the promotion. Leaves in sum the
// promoted products (hi*hi at high) and, at high, in accx the cross terms
// hi*lo + lo*hi. base is the 1024-byte aligned shared memory of the ring and
// its barriers (smem_bytes). Every thread of the block calls it.
template <int PLANES>
__device__ __forceinline__ void mainloop(const CUtensorMap* planes, TileRows rows, int ksteps,
                                         uint32_t base, float (&sum)[64],
                                         float (&accx)[PLANES == 2 ? 64 : 1]) {
  constexpr int S = stages<PLANES>();
  constexpr int kStageBytes = 2 * PLANES * kTileBytes;  // the row tiles' planes, then the column tiles'
  const uint32_t full = base + kRingBytes;  // full[s] at full + 8s, empty[s] at empty + 8s
  const uint32_t empty = full + 8 * S;

  // the stage for k-tile kt: its operand tiles of every plane, on full + 8s
  auto load = [&](int kt, int s) {
    mbar_expect_tx(full + 8 * s, kStageBytes);
    const uint32_t dst = base + s * kStageBytes;
#pragma unroll
    for (int pl = 0; pl < PLANES; ++pl) {
      tma_load(dst + pl * kTileBytes, planes, kt * kBK, rows.a + pl * rows.a_plane, full + 8 * s);
      tma_load(dst + (PLANES + pl) * kTileBytes, planes, kt * kBK, rows.b + pl * rows.b_plane,
               full + 8 * s);
    }
  };
  const bool loader = threadIdx.x == 0;  // issues every load
  if (loader) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int kt = 0; kt < min(S, ksteps); ++kt) load(kt, kt);
  }
  __syncthreads();

  // two warpgroups, rows half*64 .. +63 of the tile
  const int half = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  float acc[64];  // the products since the last promotion
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (PLANES == 2 ? 64 : 1); ++i) accx[i] = 0.0f;

  int s = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < ksteps; ++kt) {
    mbar_wait(full + 8 * s, phase);
    const uint32_t a = base + s * kStageBytes + half * (64 * kBK * 2);
    const uint32_t b = base + s * kStageBytes + PLANES * kTileBytes;
    const uint32_t keep = kt % kPromote != 0;  // 0: the batch's first products overwrite acc
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {  // 16 columns of k = 32 bytes along the row
      wgmma128(acc, desc(a + 32 * kk), desc(b + 32 * kk), kk == 0 ? keep : 1u);
      if constexpr (PLANES == 2) {
        wgmma128(accx, desc(a + 32 * kk), desc(b + kTileBytes + 32 * kk), 1u);
        wgmma128(accx, desc(a + kTileBytes + 32 * kk), desc(b + 32 * kk), 1u);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc);
    if constexpr (PLANES == 2) fence_operand(accx);
    if (kt % kPromote == kPromote - 1 || kt == ksteps - 1) {
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] += acc[i];
    }
    if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with the stage
    if (loader && kt + S < ksteps) {            // refill it once every warp is
      mbar_wait(empty + 8 * s, phase);
      load(kt + S, s);
    }
    __syncwarp();  // warp 0 whole again before the next wgmma
    if (++s == S) {
      s = 0;
      phase ^= 1;
    }
  }
}

// The tile's sums (plus the cross terms at high) through shared memory (the
// ring, now idle) into tile, row-major with row stride kLd, so that each
// thread of an epilogue may then own one column. Every thread of the block
// calls it; it ends on a __syncthreads().
template <int PLANES>
__device__ __forceinline__ void stage_sums(float* tile, const float (&sum)[64],
                                           const float (&accx)[PLANES == 2 ? 64 : 1]) {
  __syncthreads();
  const int half = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int r_own = half * 64 + (threadIdx.x / 32 % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = sum[4 * j + e];
      if constexpr (PLANES == 2) v[e] += accx[4 * j + e];
    }
    *reinterpret_cast<float2*>(&tile[r_own * kLd + col]) = make_float2(v[0], v[1]);
    *reinterpret_cast<float2*>(&tile[(r_own + 8) * kLd + col]) = make_float2(v[2], v[3]);
  }
  __syncthreads();
}

template <int PLANES, typename T, typename Addr>
__global__ void __launch_bounds__(kThreads, 1)
trailing_tc_kernel(const __grid_constant__ CUtensorMap planes, long long w, long long wpad,
                   int ksteps, long long tb, long long g, const __grid_constant__ Addr addr) {
  long long row0, col0;
  block_tile(g, g, row0, col0);
  if ((min(row0 + kBM, w) - 1) / tb < col0 / tb) return;  // every element in an upper tile

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // 128-byte swizzle wants 1024-byte tiles
  float sum[64];                     // the promoted sums
  float accx[PLANES == 2 ? 64 : 1];  // high only: hi*lo + lo*hi
  mainloop<PLANES>(&planes, TileRows{(int)row0, (int)wpad, (int)col0, (int)wpad}, ksteps, base,
                   sum, accx);
  float* tile = reinterpret_cast<float*>(smem_raw + (base - raw));
  stage_sums<PLANES>(tile, sum, accx);

  // each thread one column, every other row: C[r, c] -= tile[r, c] where r/tb >= c/tb
  const int t = threadIdx.x;
  const int c = t % kBM;
  const long long gc = col0 + c;
  if (gc >= w) return;
  const long long rmin = gc / tb * tb;
  const long long cpart = addr.col(gc);
  for (int i0 = t / kBM; i0 < kBM; i0 += 2 * kBatch) {
    T old[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long r = row0 + i0 + 2 * u;
      if (r < w && r >= rmin) old[u] = *addr.at(addr.row(r), cpart);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long r = row0 + i0 + 2 * u;
      if (r < w && r >= rmin)
        *addr.at(addr.row(r), cpart) = minus(old[u], tile[(i0 + 2 * u) * kLd + c]);
    }
  }
}

// cuTensorMapEncodeTiled through the runtime, so that nothing links libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess) ? (EncodeTiled)f : nullptr;
  }();
  return fn;
}

// The tensor map of a rows x cols bf16 matrix, row-major with leading
// dimension ld (ptr 16-byte aligned, ld a multiple of 8): boxes of kBK x kBM,
// 128-byte swizzled; a box's rows and columns past the matrix read as zeros.
// Returns a CUDA error.
inline int encode_bf16(CUtensorMap* map, const void* ptr, long long rows, long long cols,
                       long long ld) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld * 2)};
  const cuuint32_t box[2] = {kBK, kBM};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// Raise kernel's dynamic shared memory limit to bytes, once per device
// (bit d of done): a call on every launch costs host time. Returns a CUDA
// error.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (bit != 0 && (done.load(std::memory_order_acquire) & bit) != 0) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  done.fetch_or(bit, std::memory_order_release);
  return 0;
}

// the tensor-core body over a w x w window: split P into the scratch, then
// the main kernel; both on `stream`
template <typename T, int PLANES, typename Addr>
int launch(const T* p, long long w, long long nb, long long ldp, long long tb, Addr addr,
           void* scratch, long long scratch_bytes, cudaStream_t stream) {
  const long long wpad = (w + kBM - 1) / kBM * kBM;
  const long long kpad = (nb + kBK - 1) / kBK * kBK;
  const long long g = wpad / kBM;
  if (scratch_bytes < PLANES * wpad * kpad * 2 || g * g > 0x7fffffffLL ||
      PLANES * wpad > 0x7fffffffLL || kpad / kBK > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  int err = encode_bf16(&map, scratch, PLANES * wpad, kpad, kpad);
  if (err != 0) return err;

  split_kernel<T, PLANES><<<(unsigned)wpad, 256, 0, stream>>>(
      p, w, ldp, wpad, nullptr, 0, 0, 0, nb, (__nv_bfloat16*)scratch, kpad);
  err = (int)cudaGetLastError();
  if (err != 0) return err;

  auto kernel = trailing_tc_kernel<PLANES, T, Addr>;
  constexpr int smem = smem_bytes<PLANES>();
  static std::atomic<unsigned long long> smem_set{0};
  err = allow_smem(kernel, smem, smem_set);
  if (err != 0) return err;
  kernel<<<(unsigned)(g * g), kThreads, smem, stream>>>(map, w, wpad, (int)(kpad / kBK), tb, g,
                                                         addr);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace dla
