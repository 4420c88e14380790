// The two FMA-chain block bodies of the trailing-update kernels, fp32
// highest (SIMT) and fp64 (the fp64 tensor cores, DMMA), and the launch that
// picks a body for every tier: C <- C - P * P^T over the lower tb-tile pairs
// of a square window, in place.
//
// What it computes is what every body of trailing_lower.cu and
// trailing_packed.cu computes: every element with r/tb >= c/tb (whole
// diagonal tiles) becomes C[r, c] - sum_k P[r, k] * P[c, k], every other
// element is never written, and the address of element (r, c) comes from the
// kernel's address functor (row(), col(), at(); all offsets 64-bit). P holds
// the window's w rows, row-major with leading dimension ldp, nb columns;
// neither P nor ldp need be aligned.
//
// The sum. Each output is one chain acc = fma(P[r, k], P[c, k], acc), k = 0,
// 1, ... in order from +0, rounded at every step, then c - acc: the sum of
// the scalar body nt_block (trailing_block.cuh), which the task kernels still
// run at these tiers. k runs on to the next multiple of 16 over zeros, as
// nt_block's 16-column steps do, so even a -0 sum ends as nt_block's does.
// No split of k, no second partial sum, no reassociation: however the work
// is tiled, staged or ordered, the bits are nt_block's.
//
// The grid. Both bodies take one 128 x 128 output tile per block. A block
// row bi holds row_blocks(bi) tiles that reach a lower tile pair (always
// bi + 1 or more; more where tb does not divide 128 or exceeds it, since
// diagonal tb-tiles are written whole), and the grid launches exactly those:
// rows in groups of kGroup, each group walked column by column (the rows of
// a column are a suffix of the group, since row_blocks grows with bi), so
// the blocks in flight share their operand tiles in L2. The host writes each
// group's first block into the kernel's parameters (LowerGrid); a block finds
// its group by bisection and its tile in at most kGroup steps.
// tiles.chain_grid models the same map in torch.
//
// fp32 highest: trailing_simt_kernel. 256 threads, 8 x 8 outputs each (rows
// ty*4 + i and 64 + ty*4 + i, columns likewise from tx), in registers, two
// blocks an SM. P's two 128-row blocks go through shared memory 16 columns
// of k at a time, stored [k][row] (row stride 132: 128-bit reads of 4 rows,
// broadcast within a warp for the row operand, conflict-free for the column
// operand), two buffers: the next slab's global loads (128-bit where P's
// rows allow it) are in flight while this one is multiplied, then stored
// into the other buffer. Per k a thread reads 4 x 128 bits and issues 64
// FMAs.
//
// fp64: trailing_dmma_kernel. 16 warps (512 threads), each 32 x 32 outputs
// as 2 x 4 fragments of mma.sync.m16n8k4.f64 (fp64 tensor cores; the
// accumulator fragment carries from one k-step to the next in ascending k).
// P's two row blocks go through a ring of kDStages slabs of 16 columns,
// stored [row][k] with row stride 20 doubles (fragment reads free of bank
// conflicts), loaded with cp.async (16 bytes where P's rows allow it, else
// 8), kDStages - 1 slabs ahead. A thread's 32 fp64 sums take 64 of its 128
// registers; one block fills an SM's registers, and four warps a scheduler
// hide the fragment loads (8 warps of 64 x 32 outputs at 248 registers, and
// the k8 and k16 shapes, all ran slower on the card). That the tensor cores
// round each k-term as an fma does is a property of the card, not of PTX:
// dla_dmma_probe runs one instruction of each shape on given fragments, and
// the card tests hold it to an exact chain of roundings on inputs where a
// once-rounded sum, and the chain in the other order, differ.
//
// Bound. Both bodies are bound by their arithmetic (2*nb operations per
// element against one read and one write of C): fp32 FMAs outside the
// tensor cores, fp64 on the fp64 tensor cores.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "trailing_wgmma.cuh"

namespace dla {
namespace chain {

constexpr int kTile = 128;       // output tile rows = cols
constexpr int kGroup = 8;        // block rows per group of the block order
constexpr int kMaxGroups = 512;  // w up to 512 * 8 * 128 = 524288
constexpr int kSimtThreads = 256;
constexpr int kK = 16;           // k columns per slab: nt_block's step, so the same zero padding

// fp32: [k][row] slabs, two buffers; two blocks an SM (128 registers a
// thread) where P's rows take 128-bit loads, one where they do not (the
// scalar loads' guards would spill at 128)
constexpr int kSLd = kTile + 4;
constexpr int kSimtBlocks = 2;

// fp64: [row][k] slabs in a ring
constexpr int kDmmaK = 4;                      // mma.sync.m16n8k4.f64
constexpr int kDLd = kK + 4;                   // 4 mod 16: fragment reads conflict-free
constexpr int kDStages = 4;
constexpr int kDWarpsM = 4;                    // warps along the tile's rows
constexpr int kDWarpsN = 4;                    // and columns: 32 x 32 outputs each
constexpr int kDThreads = 32 * kDWarpsM * kDWarpsN;
constexpr int kMI = kTile / 16 / kDWarpsM;     // m16 fragments a warp
constexpr int kNI = kTile / 8 / kDWarpsN;      // n8 fragments a warp
constexpr int kDStage = 2 * kTile * kDLd;      // doubles of one slab: row block, column block
constexpr int kDSmem = kDStages * kDStage * 8; // 160 KB

__host__ __device__ __forceinline__ long long lmin(long long a, long long b) {
  return a < b ? a : b;
}

// The blocks launched: window w, tile tb, g block rows, and the first block
// of each group (start[groups] = every block).
struct LowerGrid {
  long long w, tb, g;
  int groups;
  unsigned start[kMaxGroups + 1];
};

// tiles of block row bi that hold an element with r/tb >= c/tb: the columns
// before the end of the tb-tile of the block's last row
__host__ __device__ __forceinline__ long long row_blocks(long long bi, long long w, long long tb,
                                                         long long g) {
  const long long last = lmin(bi * kTile + kTile - 1, w - 1);
  return lmin(g, ((last / tb + 1) * tb + kTile - 1) / kTile);
}

// Fill grid for a w x w window; a CUDA error if the grid would not fit.
inline int lower_grid(long long w, long long tb, LowerGrid& grid) {
  if (w <= 0 || tb <= 0) return (int)cudaErrorInvalidValue;
  grid.w = w;
  grid.tb = tb;
  grid.g = (w + kTile - 1) / kTile;
  const long long groups = (grid.g + kGroup - 1) / kGroup;
  if (groups > kMaxGroups) return (int)cudaErrorInvalidValue;
  grid.groups = (int)groups;
  long long total = 0;
  for (long long bi = 0; bi < grid.g; ++bi) {
    if (bi % kGroup == 0) grid.start[bi / kGroup] = (unsigned)total;
    total += row_blocks(bi, w, tb, grid.g);
  }
  if (total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  grid.start[groups] = (unsigned)total;
  return 0;
}

// this block's output tile: its group by bisection over the starts, then its
// column and row inside the group's column-by-column walk
__device__ __forceinline__ void lower_tile(const LowerGrid& grid, long long& row0,
                                           long long& col0) {
  const unsigned b = blockIdx.x;
  int lo = 0, hi = grid.groups - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (grid.start[mid] <= b) lo = mid;
    else hi = mid - 1;
  }
  const long long first = (long long)lo * kGroup;
  const int rows = (int)lmin(grid.g - first, kGroup);
  long long left = b - grid.start[lo];
  long long prev = 0;  // columns [prev, cnt) hold rows s .. rows - 1 of the group
  row0 = col0 = 0;
  for (int s = 0; s < rows; ++s) {
    const long long cnt = row_blocks(first + s, grid.w, grid.tb, grid.g);
    const long long span = (cnt - prev) * (rows - s);
    if (left < span) {
      row0 = (first + s + left % (rows - s)) * kTile;
      col0 = (prev + left / (rows - s)) * kTile;
      return;
    }
    left -= span;
    prev = cnt;
  }
}

// ---- fp32 highest: the SIMT body ------------------------------------------------------

// four floats of row `row` of P from column k, zeros past nb (row < 0: past
// the window, all zeros); 128 bits at once where VEC says P's rows allow it
template <bool VEC>
__device__ __forceinline__ void load4(const float* __restrict__ p, long long ldp, long long nb,
                                      long long row, long long k, float (&v)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = 0.0f;
  if (row < 0) return;
  const float* src = p + row * ldp + k;
  if (VEC && k + 4 <= nb) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(src));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (k + e < nb) v[e] = __ldg(src + e);
}

template <bool VEC, typename Addr>
__global__ void __launch_bounds__(kSimtThreads, VEC ? kSimtBlocks : 1)
trailing_simt_kernel(const float* __restrict__ p, long long nb, long long ldp,
                     const __grid_constant__ LowerGrid grid, const __grid_constant__ Addr addr) {
  __shared__ __align__(16) float sa[2][kK][kSLd];
  __shared__ __align__(16) float sb[2][kK][kSLd];
  long long row0, col0;
  lower_tile(grid, row0, col0);
  const long long w = grid.w;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  // staging: chunks t and t + 256 of each operand's 128 x 16 slab; chunk c is
  // row c / 4, columns 4 * (c % 4) .. + 3 (a warp reads 8 rows of 64 bytes)
  float va[2][4], vb[2][4];
  auto fetch = [&](long long k0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = threadIdx.x + e * kSimtThreads;
      const long long k = k0 + 4 * (c % 4);
      load4<VEC>(p, ldp, nb, row0 + c / 4 < w ? row0 + c / 4 : -1, k, va[e]);
      load4<VEC>(p, ldp, nb, col0 + c / 4 < w ? col0 + c / 4 : -1, k, vb[e]);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = threadIdx.x + e * kSimtThreads;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        sa[buf][4 * (c % 4) + x][c / 4] = va[e][x];
        sb[buf][4 * (c % 4) + x][c / 4] = vb[e][x];
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const long long ksteps = (nb + kK - 1) / kK;
  if (ksteps > 0) {
    fetch(0);
    stash(0);
  }
  __syncthreads();
  for (long long ks = 0; ks < ksteps; ++ks) {
    const int buf = (int)(ks & 1);
    if (ks + 1 < ksteps) fetch((ks + 1) * kK);  // in flight while this slab is multiplied
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sa[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sa[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sb[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sb[buf][kk][64 + tx * 4]);
      const float x[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float y[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(x[i], y[j], acc[i][j]);
    }
    if (ks + 1 < ksteps) stash(buf ^ 1);  // every thread left buf ^ 1 at the last barrier
    __syncthreads();
  }

  // C[r, c] -= acc where r/tb >= c/tb
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const long long c = col0 + (j < 4 ? 0 : 64) + tx * 4 + j % 4;
    if (c >= w) continue;
    const long long rmin = c / grid.tb * grid.tb;
    const long long cpart = addr.col(c);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long r = row0 + (i < 4 ? 0 : 64) + ty * 4 + i % 4;
      if (r >= w || r < rmin) continue;
      float* q = addr.at(addr.row(r), cpart);
      *q = minus(*q, acc[i][j]);
    }
  }
}

// ---- fp64: the DMMA body --------------------------------------------------------------

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// d[16 x 8] += a[16 x K] * b[8 x K]^T on the fp64 tensor cores. Lane (g, q) =
// (lane / 4, lane % 4) holds a[i] = A[g + 8 (i % 2)][q + 4 (i / 2)], b[i] =
// B[g][q + 4 i], and d[e] = D[g + 8 (e / 2)][2 q + e % 2].
template <int K>
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[K / 2],
                                     const double (&b)[K / 4]) {
  if constexpr (K == 4) {
    asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
        "{%0, %1, %2, %3};"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  } else if constexpr (K == 8) {
    asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%0, %1, %2, %3};"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
          "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
  }
}

// d[8 x 8] += a[8 x 4] * b[8 x 4]^T (sm_80's shape): a = A[g][q], b = B[g][q],
// d[e] = D[g][2 q + e]; the probe's only
__device__ __forceinline__ void dmma884(double (&d)[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

template <bool VEC, typename Addr>
__global__ void __launch_bounds__(kDThreads, 1)
trailing_dmma_kernel(const double* __restrict__ p, long long nb, long long ldp,
                     const __grid_constant__ LowerGrid grid, const __grid_constant__ Addr addr) {
  extern __shared__ __align__(16) double ring[];
  long long row0, col0;
  lower_tile(grid, row0, col0);
  const long long w = grid.w;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int wm = warp % kDWarpsM, wn = warp / kDWarpsM;  // rows wm*16*kMI .., columns wn*8*kNI ..
  const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(ring);

  // slab kt into slot: the row block's 128 rows of 16 columns, then the
  // column block's; zeros past the window and past nb
  auto load = [&](long long kt, int slot) {
    const long long k0 = kt * kK;
    constexpr int kPer = VEC ? 2 : 1;                  // doubles per copy
    constexpr int kCopies = 2 * kTile * kK / kPer / kDThreads;
#pragma unroll
    for (int e = 0; e < kCopies; ++e) {
      const int c = threadIdx.x + e * kDThreads;
      const int row = c / (kK / kPer);                 // 0 .. 255: row block, then column block
      const int kc = c % (kK / kPer) * kPer;
      const long long src_row = (row < kTile ? row0 : col0 - kTile) + row;
      const long long k = k0 + kc;
      const long long left = src_row < w ? lmin(nb - k, kPer) : 0;
      const int bytes = left > 0 ? (int)left * 8 : 0;
      const double* src = bytes ? p + src_row * ldp + k : p;
      const uint32_t dst = ring_s + (uint32_t)((slot * kDStage + row * kDLd + kc) * 8);
      if constexpr (VEC) cp_async16(dst, src, bytes);
      else cp_async8(dst, src, bytes);
    }
  };

  double acc[kMI][kNI][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0;

  const long long ksteps = (nb + kK - 1) / kK;
#pragma unroll
  for (int s = 0; s < kDStages - 1; ++s) {
    if (s < ksteps) load(s, s);
    cp_async_commit();
  }
  for (long long kt = 0; kt < ksteps; ++kt) {
    cp_async_wait<kDStages - 2>();  // slab kt has landed
    __syncthreads();                // and every warp is done with slab kt - 1's slot
    if (kt + kDStages - 1 < ksteps) load(kt + kDStages - 1, (int)((kt + kDStages - 1) % kDStages));
    cp_async_commit();
    const double* sa = ring + (kt % kDStages) * kDStage + (wm * 16 * kMI) * kDLd;
    const double* sb = ring + (kt % kDStages) * kDStage + (kTile + wn * 8 * kNI) * kDLd;
#pragma unroll
    for (int kk = 0; kk < kK; kk += kDmmaK) {
      double a[kMI][kDmmaK / 2], b[kNI][kDmmaK / 4];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int i = 0; i < kDmmaK / 2; ++i)
          a[mi][i] = sa[(mi * 16 + g + 8 * (i % 2)) * kDLd + kk + q + 4 * (i / 2)];
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
        for (int i = 0; i < kDmmaK / 4; ++i) b[ni][i] = sb[(ni * 8 + g) * kDLd + kk + q + 4 * i];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) dmma<kDmmaK>(acc[mi][ni], a[mi], b[ni]);
    }
  }
  cp_async_wait<0>();

  // C[r, c] -= acc where r/tb >= c/tb
#pragma unroll
  for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
    for (int ec = 0; ec < 2; ++ec) {
      const long long c = col0 + wn * 8 * kNI + ni * 8 + 2 * q + ec;
      if (c >= w) continue;
      const long long rmin = c / grid.tb * grid.tb;
      const long long cpart = addr.col(c);
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int er = 0; er < 2; ++er) {
          const long long r = row0 + wm * 16 * kMI + mi * 16 + g + 8 * er;
          if (r >= w || r < rmin) continue;
          double* d = addr.at(addr.row(r), cpart);
          *d = minus(*d, acc[mi][ni][2 * er + ec]);
        }
    }
}

// one instruction of shape m16n8k`shape` (4, 8, 16) or, shape 0, m8n8k4:
// D = C + A * B^T with A (M x K), B (8 x K), C and D (M x 8), all row-major
template <int K>
__global__ void dmma_probe_kernel(const double* a, const double* b, const double* c, double* d) {
  const int g = threadIdx.x / 4, q = threadIdx.x % 4;
  if constexpr (K == 0) {
    double acc[2] = {c[g * 8 + 2 * q], c[g * 8 + 2 * q + 1]};
    dmma884(acc, a[g * 4 + q], b[g * 4 + q]);
    d[g * 8 + 2 * q] = acc[0];
    d[g * 8 + 2 * q + 1] = acc[1];
  } else {
    double fa[K / 2], fb[K / 4], acc[4];
#pragma unroll
    for (int i = 0; i < K / 2; ++i) fa[i] = a[(g + 8 * (i % 2)) * K + q + 4 * (i / 2)];
#pragma unroll
    for (int i = 0; i < K / 4; ++i) fb[i] = b[g * K + q + 4 * i];
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = c[(g + 8 * (e / 2)) * 8 + 2 * q + e % 2];
    dmma<K>(acc, fa, fb);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[(g + 8 * (e / 2)) * 8 + 2 * q + e % 2] = acc[e];
  }
}

inline int probe(const double* a, const double* b, const double* c, double* d, int shape,
                 cudaStream_t s) {
  switch (shape) {
    case 0: dmma_probe_kernel<0><<<1, 32, 0, s>>>(a, b, c, d); break;
    case 4: dmma_probe_kernel<4><<<1, 32, 0, s>>>(a, b, c, d); break;
    case 8: dmma_probe_kernel<8><<<1, 32, 0, s>>>(a, b, c, d); break;
    case 16: dmma_probe_kernel<16><<<1, 32, 0, s>>>(a, b, c, d); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---- launches -------------------------------------------------------------------------

// P's rows start on 16 bytes: the pointer and every row
template <typename T> bool rows_aligned(const T* p, long long ldp) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (ldp * (long long)sizeof(T)) % 16 == 0;
}

template <typename Addr>
int launch_simt(const float* p, long long w, long long nb, long long ldp, long long tb, Addr addr,
                cudaStream_t s) {
  LowerGrid grid;
  const int err = lower_grid(w, tb, grid);
  if (err != 0) return err;
  const unsigned blocks = grid.start[grid.groups];
  if (rows_aligned(p, ldp))
    trailing_simt_kernel<true, Addr><<<blocks, kSimtThreads, 0, s>>>(p, nb, ldp, grid, addr);
  else
    trailing_simt_kernel<false, Addr><<<blocks, kSimtThreads, 0, s>>>(p, nb, ldp, grid, addr);
  return (int)cudaGetLastError();
}

template <bool VEC, typename Addr>
int launch_dmma_kernel(const double* p, long long nb, long long ldp, const LowerGrid& grid,
                       Addr addr, cudaStream_t s) {
  auto kernel = trailing_dmma_kernel<VEC, Addr>;
  static std::atomic<unsigned long long> smem_set{0};
  const int err = tc::allow_smem(kernel, kDSmem, smem_set);
  if (err != 0) return err;
  kernel<<<grid.start[grid.groups], kDThreads, kDSmem, s>>>(p, nb, ldp, grid, addr);
  return (int)cudaGetLastError();
}

template <typename Addr>
int launch_dmma(const double* p, long long w, long long nb, long long ldp, long long tb,
                Addr addr, cudaStream_t s) {
  LowerGrid grid;
  const int err = lower_grid(w, tb, grid);
  if (err != 0) return err;
  return rows_aligned(p, ldp) ? launch_dmma_kernel<true>(p, nb, ldp, grid, addr, s)
                              : launch_dmma_kernel<false>(p, nb, ldp, grid, addr, s);
}

}  // namespace chain

// Launches of both trailing kernels in this process through each body,
// counted where a launch succeeds; dla_trailing_body_launches
// (trailing_lower.cu) reads them.
enum TrailingBody { kSimtBody = 0, kWgmmaBody = 1, kDmmaBody = 2 };
inline long long trailing_body_launches[3] = {0, 0, 0};

inline int counted(int err, TrailingBody body) {
  if (err == 0) ++trailing_body_launches[body];
  return err;
}

// Launch the update over a w x w window on `stream`. The body follows the
// storage type and tier: fp32 highest the SIMT body, fp64 (every tier) the
// DMMA body, fp32 high the tensor-core body with two bf16 planes of P, fp32
// default and bf16 storage (any tier) with one (kernels/tiles.py:split_planes
// and trailing_body keep the same table). scratch holds scratch_bytes for the
// planes; the chain bodies do not read it. Returns the CUDA error of the
// first step that failed (0 = launched); a refused launch is never retried
// through another body.
template <typename T, typename Addr>
int launch_trailing(int tier, const void* p, long long w, long long nb, long long ldp,
                    long long tb, Addr addr, void* scratch, long long scratch_bytes,
                    void* stream) {
  if (w <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const T* pp = (const T*)p;
  if constexpr (std::is_same_v<T, float>) {
    switch (tier) {
      case kHighest:
        return counted(chain::launch_simt(pp, w, nb, ldp, tb, addr, s), kSimtBody);
      case kHigh:
        return counted(tc::launch<T, 2>(pp, w, nb, ldp, tb, addr, scratch, scratch_bytes, s),
                       kWgmmaBody);
      case kDefault:
        return counted(tc::launch<T, 1>(pp, w, nb, ldp, tb, addr, scratch, scratch_bytes, s),
                       kWgmmaBody);
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else if constexpr (std::is_same_v<T, double>) {
    (void)tier, (void)scratch, (void)scratch_bytes;
    return counted(chain::launch_dmma(pp, w, nb, ldp, tb, addr, s), kDmmaBody);
  } else {
    (void)tier;
    return counted(tc::launch<T, 1>(pp, w, nb, ldp, tb, addr, scratch, scratch_bytes, s),
                   kWgmmaBody);
  }
}

}  // namespace dla
