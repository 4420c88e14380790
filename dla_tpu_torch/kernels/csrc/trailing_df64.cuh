// The block body shared by the two df64 trailing-update kernels:
// (C_hi, C_lo) <- C - P * P^T over the lower tile pairs of a square window,
// in place on both fp32 planes, with P given as its s exact bf16 slices.
//
// trailing_df64.cu writes the window into a dense pair, trailing_packed_df64.cu
// into a column-slab packed pair. They differ only in where element (r, c) of
// the window lives, so the kernel is here once, templated on an offset functor
// Addr: row(r) + col(c) is element (r, c)'s offset, the same in both planes.
//
// What it computes, as _df64_accum_body (dla_tpu/kernels/df64_tiles.py:51-92).
// The w x w window is cut into tb x tb tiles; every element (r, c) of the
// window with r/tb >= c/tb (whole diagonal tiles) goes through
//
//   for each k-chunk of kb = min(nb, 2^(26-2w)) columns:
//     for i in 0..s-1, j in 0..s-1-i:            // this order, always
//       p = sum_{k in chunk} P_i[r, k] * P_j[c, k]
//       if i + j <= precise_deg: (hi, e) = two_sum(hi, -p); lo += e
//       else:                    lo -= p
//   (C_hi, C_lo)[r, c] = quick_two_sum(hi, lo)   // after the last chunk
//
// and every other element is never written. The result has the bits of the
// plain torch versions, trailing_update_df64_plain and
// trailing_update_packed_df64_plain.
//
// Why the tensor cores give those bits. slice_rows puts row r of slice t on
// the grid g_t(r) = mu_r * 2^(1-(t+1)w), |P_t[r, k]| <= 2^(w-1) grid units. So
// every product of pair (i, j) at (r, c) is an integer multiple of
// G = g_i(r) * g_j(c) of at most 2^(2w-2) units, exact in bf16 x bf16 -> fp32,
// and every partial sum of a chunk's kb = 2^(26-2w) products is an integer of
// at most 2^24 units. wgmma's fp32 accumulation does not round to nearest: per
// k16 step it aligns the 16 products and the running sum to the largest of
// their exponents and keeps about 24 bits below it (trailing_wgmma.cuh,
// "Promotion"). Here that largest input is the running sum of at most kb - 16
// products, or a product: below 2^24 units, so its leading bit is at most
// 2^23 units and 24 bits reach down to the unit itself. Nothing is cut, each
// step's sum is an integer of at most 2^24 units, exact in fp32, and p comes
// out exactly, whatever the order of the k16 steps, with no promotion.
// tests/test_torch_df64_schedule.py holds a model of that truncating
// accumulator to the plain version's bits on the CPU, the extreme chunks
// (every product 2^(2w-2) units of one sign: a sum of exactly 2^24 units;
// alternating signs) included; the card tests hold this kernel to them. Only
// the (i, j) order and the compensation steps round, and those are written
// with __fadd_rn/__fsub_rn, which nvcc never contracts or reorders (-ftz stays
// off).
//
// Subnormals. The argument needs every product unit G in fp32's normal range.
// The smallest is that of the last pairs, i + j = s - 1: mu_r * mu_c *
// 2^(2-(s+1)w), 2^-62 * mu_r * mu_c at s = 7, w = 8. It leaves the normal range
// where mu_r * mu_c < 2^-64, rows whose largest element is below about 2^-32
// on both sides; the factors of the paths' matrices (plgsy with bump N) have
// rows far above that. Nothing here special-cases it.
//
// Design: the pipeline of trailing_wgmma.cuh. One 128 x 128 output tile per
// block, two consumer warpgroups of wgmma.m64n128k16 (64 rows each), bf16
// operands K-major, thread 0 issuing the TMA loads into a ring of 5 stages of
// 32 KB: the row tile of P_i and the column tile of P_j, 64 columns of k,
// each from its slice's own tensor map (up to 8 __grid_constant__ maps, no
// copy of the slices; TMA reads zeros past the slices' rows and columns, and
// zeros add nothing, so a ragged w or nb needs no path of its own). The ring
// runs through the whole sequence of (chunk, i, j, k-step) stages, which the
// loader walks with a cursor, so the next pair's loads are in flight while a
// pair is folded. Each thread holds lo and one accumulator in registers, 2 x
// 64 fp32 in wgmma's fragment layout, and its 64 elements of hi in shared
// memory ([e][thread], 64 KB a block, no bank conflicts): each pair's k-loop
// writes the accumulator fresh, and at the pair's end it is folded, the
// compensated pairs (i + j <= precise_deg, 10 of 28 at s = 7) through hi and
// lo, the others into lo alone. With hi in registers too, ptxas spills at the
// compensated fold (255 registers); with lo in shared memory instead, every
// fold goes through it. Both measured slower or spilling (PERF.md, PR 14).
// hi and lo come in before the first fold and go out after the last through
// the idle ring, each thread reading and writing one column of the tile
// (coalesced, no thread holding many addresses), at Addr's offsets split as
// row(r) + col(c) and computed per tile into shared memory with each row's
// end of the mask (no 64-bit division per element; 64-bit offsets: a dense
// plane passes 2^31 elements at m = 46341, a packed one with 1024-wide slabs
// at n = 65536). Blocks are numbered in groups of 8 row tiles walked column
// by column (block_tile), and a block whose rows all lie above the
// tb-diagonal returns at once.
//
// Bound. s(s+1)/2 bf16 products (28 at s = 7) over the panel width for each
// visited element, against one read and one write of the C pair: the tensor
// cores bind. Each block streams its 2 x 28 operand tiles of 128 x nb bf16 from
// L2 (14.7 MB per tile at nb = 1024), which may set the pace before them.

#pragma once

#include "trailing_wgmma.cuh"

#define DF64_MAX_SLICES 8

namespace dla {
namespace {  // each including source its own kernels and once-per-device flag of allow_smem
namespace df64 {

constexpr int kStageBytes = 2 * tc::kTileBytes;  // the row tile of P_i, then the column tile of P_j
constexpr int kStages = 5;
constexpr int kRing = kStages * kStageBytes;          // the ring's bytes: 160 KB
constexpr int kHiBytes = 64 * tc::kThreads * 4;       // hi, 64 per thread: 64 KB
constexpr int kPlane = tc::kBM * tc::kLd;             // floats of one staged plane of the C tile
constexpr int kTables = (8 + 8 + 4) * tc::kBM;  // the tile's row offsets, column offsets, row ends
static_assert(kPlane * 4 + kTables <= kRing, "a staged plane and the tables fit the ring");
constexpr int kSmemBytes = 1024 /* alignment slack */ + kRing + kHiBytes + 2 * kStages * 8;

// one tensor map per slice, read where the launch put them
struct SliceMaps {
  CUtensorMap map[DF64_MAX_SLICES];
};

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float v = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, v)), __fsub_rn(b, v));
}

// wgmma's accumulator element e (0..63) of this thread: tile row and column
__device__ __forceinline__ int frag_row(int e) {
  const int lane = threadIdx.x % 32;
  return threadIdx.x / 128 * 64 + threadIdx.x / 32 % 4 * 16 + lane / 4 + 8 * (e % 4 / 2);
}
__device__ __forceinline__ int frag_col(int e) {
  return 8 * (e / 4) + 2 * (threadIdx.x % 4) + e % 2;
}

template <typename Addr>
__global__ void __launch_bounds__(tc::kThreads, 1)
trailing_df64_tc_kernel(float* __restrict__ ch, float* __restrict__ cl,
                        const __grid_constant__ SliceMaps maps, long long w, long long tb,
                        long long g, int s, int nk, int kb, int ksteps, int precise_deg,
                        const __grid_constant__ Addr addr) {
  using namespace tc;
  long long row0, col0;
  block_tile(g, g, row0, col0);
  if ((min(row0 + kBM, w) - 1) / tb < col0 / tb) return;  // every element in an upper tile

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // 1024-byte swizzled tiles
  // the ring, then hi ([e][thread]: conflict-free), then the mbarriers
  // (full[st] at full + 8st, empty[st] at empty + 8st)
  float* const tile = reinterpret_cast<float*>(smem_raw + (base - raw));  // a staged plane
  float* const hi = tile + kRing / 4 + threadIdx.x;  // this thread's hi[e] at hi[e * kThreads]
  const uint32_t full = base + kRing + kHiBytes;
  const uint32_t empty = full + 8 * kStages;
  // Before and after the k-loop, in the ring past the staged plane: Addr
  // split as row(r) + col(c), each computed once for the tile (the packed map
  // divides by the slab width), and how many of each row's columns in the
  // tile are visited: up to (r/tb + 1) * tb, at most w, none past the window.
  // They are made again for the epilogue, when no register is live across
  // the 64-bit divisions' calls.
  long long* const row_off = reinterpret_cast<long long*>(tile + kPlane);
  long long* const col_off = row_off + kBM;
  int* const row_end = reinterpret_cast<int*>(col_off + kBM);
  auto make_tables = [&] {
    long long row0, col0;
    block_tile(g, g, row0, col0);
    if (threadIdx.x < kBM) {
      const long long c = col0 + threadIdx.x;
      col_off[threadIdx.x] = c < w ? addr.col(c) : 0;
    } else {
      const int t = threadIdx.x - kBM;
      const long long r = row0 + t;
      row_off[t] = r < w ? addr.row(r) : 0;
      const long long end = min(w, (r / tb + 1) * tb) - col0;  // past the tile's last column
      row_end[t] = r < w ? (int)max(0LL, min((long long)kBM, end)) : 0;
    }
  };
  make_tables();
  const int row0i = (int)row0, col0i = (int)col0;  // TMA coordinates
  const int npairs = s * (s + 1) / 2;
  const int total = nk * npairs * ksteps;  // stages in the whole sequence

  // the next stage of the sequence (chunk, i, j, k-step) into ring slot st:
  // the loader walks it with a cursor (li, lj, lk, lc), in order; decoding a
  // stage number instead takes two integer divisions per stage on the
  // loader's thread, and measured 30% slower
  const CUtensorMap* const map = maps.map;
  int li = 0, lj = 0, lk = 0, lc = 0;
  auto load = [&](int st) {
    const int k = lc * kb + lk * kBK;
    const uint32_t dst = base + st * kStageBytes;
    mbar_expect_tx(full + 8 * st, kStageBytes);
    tma_load(dst, map + li, k, row0i, full + 8 * st);
    tma_load(dst + kTileBytes, map + lj, k, col0i, full + 8 * st);
    if (++lk == ksteps) {
      lk = 0;
      if (++lj == s - li) {
        lj = 0;
        if (++li == s) {
          li = 0;
          ++lc;
        }
      }
    }
  };
  __syncthreads();

  // One plane of the C pair's tile through the idle ring: its visited
  // elements, read (written) column by column, each thread one column, every
  // other row (coalesced), zeros elsewhere. A thread never holds 64 addresses.
  auto stage_in = [&](const float* plane) {
    for (int r = threadIdx.x / kBM, c = threadIdx.x % kBM; r < kBM; r += kThreads / kBM)
      tile[r * kLd + c] = c < row_end[r] ? plane[row_off[r] + col_off[c]] : 0.0f;
  };
  auto stage_out = [&](float* plane) {
    for (int r = threadIdx.x / kBM, c = threadIdx.x % kBM; r < kBM; r += kThreads / kBM)
      if (c < row_end[r]) plane[row_off[r] + col_off[c]] = tile[r * kLd + c];
  };
  // hi into shared memory and lo into registers, in the accumulator's layout
  float lo[64], acc[64];
  stage_in(ch);
  __syncthreads();
#pragma unroll
  for (int e = 0; e < 64; ++e) hi[e * kThreads] = tile[frag_row(e) * kLd + frag_col(e)];
  __syncthreads();
  stage_in(cl);
  __syncthreads();
#pragma unroll
  for (int e = 0; e < 64; ++e) lo[e] = tile[frag_row(e) * kLd + frag_col(e)];
  __syncthreads();  // the ring is free for the loads

  const bool loader = threadIdx.x == 0;
  if (loader) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int st = 0; st < min(kStages, total); ++st) load(st);
  }
  __syncthreads();

  const int half = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  // stage q of the sequence is k-step kt of pair (i, j) of its chunk
  int i = 0, j = 0, kt = 0;
  for (int q = 0; q < total; ++q) {
    const int st = q % kStages;
    const uint32_t phase = q / kStages & 1;
    mbar_wait(full + 8 * st, phase);
    const uint32_t a = base + st * kStageBytes + half * (64 * kBK * 2);
    const uint32_t b = base + st * kStageBytes + kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)  // the pair's first products overwrite acc
      wgmma128(acc, desc(a + 32 * kk), desc(b + 32 * kk), (kt | kk) != 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc);
    if (lane == 0) mbar_arrive(empty + 8 * st);  // this warp is done with the stage
    if (loader && q + kStages < total) {          // refill it once every warp is
      mbar_wait(empty + 8 * st, phase);
      load(st);
    }
    __syncwarp();  // warp 0 whole again before the next wgmma
    if (++kt < ksteps) continue;

    // the pair's exact chunk product into (hi, lo), in the reference's order
    kt = 0;
    if (i + j <= precise_deg) {
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        float sum, err;
        two_sum(hi[e * kThreads], -acc[e], sum, err);
        hi[e * kThreads] = sum;
        lo[e] = __fadd_rn(lo[e], err);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 64; ++e) lo[e] = __fsub_rn(lo[e], acc[e]);
    }
    if (++j == s - i) {
      j = 0;
      if (++i == s) i = 0;  // the next chunk
    }
  }

  // quick_two_sum(hi, lo), out through the ring (idle: every warp's last
  // products are done, and no load is in flight), one plane after the other
  __syncthreads();
#pragma unroll
  for (int e = 0; e < 64; ++e) {  // hi's slot takes the new lo: no register stays live
    const float sum = __fadd_rn(hi[e * kThreads], lo[e]);
    hi[e * kThreads] = __fsub_rn(lo[e], __fsub_rn(sum, hi[e * kThreads]));
    tile[frag_row(e) * kLd + frag_col(e)] = sum;
  }
  make_tables();
  __syncthreads();
  stage_out(ch);
  __syncthreads();
#pragma unroll
  for (int e = 0; e < 64; ++e) tile[frag_row(e) * kLd + frag_col(e)] = hi[e * kThreads];
  __syncthreads();
  stage_out(cl);
}

}  // namespace df64

// Launch the kernel over a w x w window on `stream`. slices is a host array
// of s device pointers to the w x nb bf16 slices (leading dimension ldp; each
// pointer 16-byte aligned and ldp a multiple of 8, as TMA asks), kb the exact
// chunk (nb a multiple of it, and of the 64-column k-step when there is more
// than one chunk). Returns the CUDA error of the first step that failed (0 =
// launched).
template <typename Addr>
int launch_trailing_df64(void* ch, void* cl, const void* const* slices, long long w,
                         long long nb, long long ldp, long long tb, long long kb, int s,
                         int precise_deg, Addr addr, void* stream) {
  using namespace tc;
  if (s < 1 || s > DF64_MAX_SLICES || kb < 1 || tb < 1) return (int)cudaErrorInvalidValue;
  if (w <= 0 || nb <= 0) return 0;
  const long long nk = nb / kb;
  if (nb % kb != 0 || (nk > 1 && kb % kBK != 0) || ldp < nb || ldp % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const long long ksteps = (kb + kBK - 1) / kBK;
  const long long g = (w + kBM - 1) / kBM;
  if (g * g > 0x7fffffffLL || w > 0x7fffffffLL || nb > 0x7fffffffLL ||
      nk * (s * (s + 1) / 2) * ksteps > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  df64::SliceMaps maps{};
  for (int t = 0; t < s; ++t) {
    if (reinterpret_cast<uintptr_t>(slices[t]) % 16 != 0) return (int)cudaErrorInvalidValue;
    const int err = encode_bf16(&maps.map[t], slices[t], w, nb, ldp);
    if (err != 0) return err;
  }
  auto kernel = df64::trailing_df64_tc_kernel<Addr>;
  static std::atomic<unsigned long long> smem_set{0};
  int err = allow_smem(kernel, df64::kSmemBytes, smem_set);
  if (err != 0) return err;
  kernel<<<(unsigned)(g * g), kThreads, df64::kSmemBytes, (cudaStream_t)stream>>>(
      (float*)ch, (float*)cl, maps, w, tb, g, s, (int)nk, (int)kb, (int)ksteps, precise_deg,
      addr);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace dla
