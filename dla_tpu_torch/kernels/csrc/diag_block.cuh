// The factor-and-invert phase shared by panel_factor.cu and potrf_tile.cu:
// tril(L) of one SPD block and inv(L), so that the panel kernel and the
// tile task kernel cannot drift apart.
//
// Replaces _factor_lower and _invert_lower of dla_tpu/kernels/pallas_tiles.py
// (the math, not the masked column extraction that Mosaic needs).
//
// Design. The n x n block is cut into 64 x 64 tiles (nt = ceil(n / 64), the
// last one ragged) and computed in nt + 1 launches on the caller's stream.
// Launch t runs factor stage t and inverse stage t - 1 side by side; the
// blocks of a launch touch disjoint tiles, and the stream orders the
// launches.
//   factor stage K: a panel block for each tile (I, K), I >= K, applies tile
//     column K-1 of L to its tile and to the diagonal tile (K, K), factors
//     the diagonal tile (every panel block does so for itself, so no block
//     waits for another), then solves its tile's rows against it. A trailing
//     block for each tile (I, J), I >= J > K, applies tile column K-1 to it.
//     Partial sums of the tiles below the diagonal live in l, where their L
//     goes; those of the diagonal tiles in x, which the inverse overwrites
//     later. Stages 0 and 1 read them from the input.
//   inverse stage J: a panel block for each tile (J, C), C <= J, applies
//     tile row J-1 of X to it, then substitutes its columns against L_JJ; a
//     trailing block for each tile (I, C), I > J > C, applies tile row J-1.
//     A tile starts from the identity's tile when a stage first touches it.
//     Stage J reads columns J-1 and J of L, final after factor stage J, and
//     writes x only below the diagonal or in row J.
// 256 threads a block. A product holds 4 x 4 outputs a thread in registers
// and reads its operands from shared-memory tiles with a row stride of 65,
// so that neither operand's reads conflict. The diagonal factor spreads a
// column over 64 threads, one element each, so that a step's divisions run
// at once (two barriers a step). The solves give a row (a column) to four
// threads, which pass each quotient by a shuffle. Three tiles, a column and
// a pivot take 50,180 bytes of dynamic shared memory in fp32, 100,360 in
// fp64.
//
// Bits. Every element gets the operations of the plain versions
// (_factor_lower_plain, _invert_lower_plain of kernels/tiles.py) in their
// order: L[r][c] its products for j < c ascending, then its division by the
// pivot sqrt(L[c][c]); X[r][c] its products for j = c .. r-1 ascending, then
// its division by L[r][r]. No sum is split or reordered, so the schedule
// changes no bit: tests/test_torch_diag_schedule.py runs it in torch ops on
// the CPU and holds it to the plain versions' bits, and the card tests hold
// the kernel to them.
//
// Precision, as _kernel_precision (pallas_tiles.py:60-65): fp32 products
// rounded once (high is promoted to highest), bf16-rounded operands at
// default (their products are exact in fp32; the stored L is not rounded),
// fp64 for fp64. Every product, difference, quotient and root is an _rn
// intrinsic, so nvcc contracts none of them into an FMA and the kernel
// rounds where the plain version does.
//
// Bound. Latency: the n pivots form a chain (a launch waits for 64 steps of
// the diagonal factor, each a square root and a division, and 64 steps of a
// solve, each a division and a shuffle), and at n = 512 a launch runs 8 to
// 29 blocks; the operations (n^3/3 of each half) would take microseconds on
// the card. The callers cap n at 512 (kMaxNb).

#pragma once

#include "trailing_block.cuh"

namespace dla {

constexpr int kMaxNb = 512;  // the reference's VMEM cap of panel_factor
constexpr int kDB = 64;      // tile edge
constexpr int kDP = kDB + 1;  // shared-memory row stride
constexpr int kDThreads = 256;  // 16 x 16, 4 x 4 outputs each in the products
static_assert(kDB == 16 * TM && kDThreads == 4 * kDB,
              "the layouts: 4 x 4 outputs a thread in the products, four threads a row in "
              "the solves and the factor");

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

// an operand of a rank-1 step: bf16-rounded at default (fp32 only)
template <typename T, int TIER>
__device__ __forceinline__ T step_operand(T v) {
  if constexpr (std::is_same_v<T, float> && TIER == kDefault) {
    return round_bf16(v);
  } else {
    return v;
  }
}

template <typename T>
constexpr int diag_smem_bytes() {
  return (3 * kDB * kDP + kDB + 1) * (int)sizeof(T);  // three tiles, a column and a pivot
}

// The launches of the schedule at n (nt tiles a side), and each one's grid.
__host__ __device__ constexpr int diag_tiles(long long n) { return (int)((n + kDB - 1) / kDB); }
__host__ __device__ constexpr int factor_blocks(int nt, int k) {
  return nt - k + (k ? (nt - k - 1) * (nt - k) / 2 : 0);
}
__host__ __device__ constexpr int inverse_blocks(int nt, int j) { return j + 1 + j * (nt - 1 - j); }
// launch t runs factor stage t and inverse stage t - 1, t = 0 .. nt
__host__ __device__ constexpr int stage_blocks(int nt, int t) {
  return (t < nt ? factor_blocks(nt, t) : 0) + (t ? inverse_blocks(nt, t - 1) : 0);
}

// Tile (r0, c0) of src (leading dimension ld) into s: element (r, c) where
// r0 + r < n, c0 + c < n and, for a lower tile, c <= r; 0 elsewhere, so the
// upper triangle of a diagonal tile is never read. OP rounds each element as
// a step operand; TRANS stores s[c][r].
template <typename T, int TIER, bool OP, bool TRANS>
__device__ __forceinline__ void load_tile(T* s, const T* src, long long ld, int r0, int c0,
                                          int n, bool lower) {
#pragma unroll  // all the loads in flight at once
  for (int q = 0; q < kDB * kDB / kDThreads; ++q) {
    const int e = threadIdx.x + q * kDThreads, r = e / kDB, c = e % kDB;
    T v = T(0);
    if (r0 + r < n && c0 + c < n && (!lower || c <= r)) {
      v = src[(long long)(r0 + r) * ld + c0 + c];
      if constexpr (OP) v = step_operand<T, TIER>(v);
    }
    s[TRANS ? c * kDP + r : r * kDP + c] = v;
  }
}

// s into tile (r0, c0) of dst, inside n x n (TRANS: s holds the tile
// transposed); a lower tile gets zeros above its diagonal.
template <bool TRANS, typename T>
__device__ __forceinline__ void store_tile(T* dst, long long ld, int r0, int c0, int n,
                                           const T* s, bool lower) {
#pragma unroll
  for (int q = 0; q < kDB * kDB / kDThreads; ++q) {
    const int e = threadIdx.x + q * kDThreads, r = e / kDB, c = e % kDB;
    if (r0 + r < n && c0 + c < n)
      dst[(long long)(r0 + r) * ld + c0 + c] =
          lower && c > r ? T(0) : s[TRANS ? c * kDP + r : r * kDP + c];
  }
}

// zeros into the tiles right of diagonal tile R of dst: an output's upper part
template <typename T>
__device__ __forceinline__ void zero_right(T* dst, long long ld, int R, int n) {
  const int r0 = R * kDB, c0 = r0 + kDB;
  const int rows = min(kDB, n - r0), cols = n - c0;
  for (int e = threadIdx.x; e < rows * max(cols, 0); e += kDThreads)
    dst[(long long)(r0 + e / cols) * ld + c0 + e % cols] = T(0);
}

// A thread's 4 x 4 elements of a tile: rows ty + 16 i, columns tx + 16 j.
__device__ __forceinline__ int row_of(int i) { return (int)threadIdx.x / 16 + 16 * i; }
__device__ __forceinline__ int col_of(int j) { return (int)threadIdx.x % 16 + 16 * j; }

// ... from tile (r0, c0) of src, as load_tile does
template <typename T>
__device__ __forceinline__ void regs_load(T (&v)[TM][TM], const T* src, long long ld, int r0,
                                          int c0, int n, bool lower) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int r = row_of(i), c = col_of(j);
      v[i][j] = r0 + r < n && c0 + c < n && (!lower || c <= r)
                    ? src[(long long)(r0 + r) * ld + c0 + c] : T(0);
    }
}

template <typename T>
__device__ __forceinline__ void regs_store(T* dst, long long ld, int r0, int c0, int n,
                                           const T (&v)[TM][TM]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int r = row_of(i), c = col_of(j);
      if (r0 + r < n && c0 + c < n) dst[(long long)(r0 + r) * ld + c0 + c] = v[i][j];
    }
}

// ... into s; TRANS stores s[c][r]
template <bool TRANS, typename T>
__device__ __forceinline__ void regs_to(T* s, const T (&v)[TM][TM]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j)
      s[TRANS ? col_of(j) * kDP + row_of(i) : row_of(i) * kDP + col_of(j)] = v[i][j];
}

// v[r][c] <- v[r][c] - a[r][k] * b[c][k] for k = 0 .. 63 in ascending order
// (operands already rounded); with KGEC only the terms k >= c. LOWER skips
// the thread's elements that lie above the diagonal whatever the thread (a
// diagonal tile's, which nothing reads).
template <typename T, bool KGEC, bool LOWER = false>
__device__ __forceinline__ void apply(T (&v)[TM][TM], const T* a, const T* b) {
#pragma unroll 4
  for (int k = 0; k < kDB; ++k) {
    T x[TM], y[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      x[i] = a[row_of(i) * kDP + k];
      y[i] = b[col_of(i) * kDP + k];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        if (LOWER && j > i) continue;  // column tx + 16 j > row ty + 16 i
        const T u = sub_rn(v[i][j], mul_rn(x[i], y[j]));
        if (!KGEC || k >= col_of(j)) v[i][j] = u;
      }
  }
}

// The diagonal tile d (shared memory, nv x nv valid; only c <= r is read)
// <- its Cholesky factor by nv rank-1 steps, written back transposed
// (d[c][r] = L[r][c]). Thread t holds row t % 64 at the columns t / 64 + 4k
// in registers, so a column is spread over 64 threads, one element each: at
// step j those 64 divide by the pivot at once and put the rounded column in
// stage[]; then every thread updates its elements j < c <= r, and the holder
// of (j+1, j+1) puts that element, now final, in stage[kDB]. Two barriers a
// step. Starts after a barrier; ends on one.
template <typename T, int TIER>
__device__ __forceinline__ void factor_diag(T* d, T* stage, int nv) {
  constexpr int kCols = kDB * kDB / kDThreads;  // 16
  const int r = threadIdx.x % kDB, cg = threadIdx.x / kDB;
  T v[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) v[k] = d[r * kDP + cg + 4 * k];
  if (threadIdx.x == 0) stage[kDB] = v[0];
#pragma unroll
  for (int kq = 0; kq < kCols; ++kq)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = 4 * kq + s;
      if (j >= nv) break;
      __syncthreads();  // the pivot's square is in the stage, the last step's reads are done
      if (cg == s) {  // this thread holds (r, j)
        const T piv = sqrt_rn(stage[kDB]);
        if (r > j) {
          v[kq] = div_rn(v[kq], piv);
          stage[r] = step_operand<T, TIER>(v[kq]);
        } else if (r == j) {
          v[kq] = piv;
        }
      }
      __syncthreads();  // the column is in the stage
      const T sr = stage[r];
#pragma unroll
      for (int k = kq; k < kCols; ++k) {
        const int c = cg + 4 * k;
        if (c > j && c <= r) v[k] = sub_rn(v[k], mul_rn(sr, stage[c]));
      }
      const int j1 = j + 1;
      if (r == j1 && cg == j1 % 4) stage[kDB] = v[j1 / 4 < kCols ? j1 / 4 : 0];
    }
#pragma unroll
  for (int k = 0; k < kCols; ++k) d[(cg + 4 * k) * kDP + r] = v[k];
  __syncthreads();
}

// The rows of tile t (shared memory) solved against the factored diagonal
// tile, given transposed (dt[j][c] = d[c][j]): for j < nv ascending,
// t[r][j] /= d[j][j], then t[r][c] -= op(t[r][j]) * op(d[c][j]) for c > j.
// Four threads to a row, each holding its columns sub + 4m in registers; the
// one that holds column j passes the quotient to the other three by a
// shuffle. Each thread reads and writes its own elements only.
template <typename T, int TIER>
__device__ __forceinline__ void solve_rows(T* t, const T* dt, int nv) {
  const int r = threadIdx.x / 4, sub = threadIdx.x % 4, base = threadIdx.x % 32 & ~3;
  T v[kDB / 4];
#pragma unroll
  for (int m = 0; m < kDB / 4; ++m) v[m] = t[r * kDP + sub + 4 * m];
#pragma unroll
  for (int m = 0; m < kDB / 4; ++m)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = 4 * m + s;
      if (j >= nv) break;
      const T x = __shfl_sync(0xffffffffu, div_rn(v[m], dt[j * kDP + j]), base + s);
      if (sub == s) v[m] = x;
      const T o = step_operand<T, TIER>(x);
#pragma unroll
      for (int mm = m; mm < kDB / 4; ++mm)
        if (sub + 4 * mm > j)
          v[mm] = sub_rn(v[mm], mul_rn(o, step_operand<T, TIER>(dt[j * kDP + sub + 4 * mm])));
    }
#pragma unroll
  for (int m = 0; m < kDB / 4; ++m) t[r * kDP + sub + 4 * m] = v[m];
}

// The columns of tile t (shared memory) substituted against L_JJ (l): for
// j < nv ascending, t[j][c] /= l[j][j], then t[r][c] -= op(l[r][j]) *
// op(t[j][c]) for r > j; on a diagonal tile column c takes only the steps
// j >= c. Four threads to a column, each holding its rows sub + 4m.
template <typename T, int TIER>
__device__ __forceinline__ void solve_cols(T* t, const T* l, int nv, bool diag) {
  const int c = threadIdx.x / 4, sub = threadIdx.x % 4, base = threadIdx.x % 32 & ~3;
  T v[kDB / 4];
#pragma unroll
  for (int m = 0; m < kDB / 4; ++m) v[m] = t[(sub + 4 * m) * kDP + c];
#pragma unroll
  for (int m = 0; m < kDB / 4; ++m)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = 4 * m + s;
      if (j >= nv) break;
      const T x = __shfl_sync(0xffffffffu, div_rn(v[m], l[j * kDP + j]), base + s);
      if (!diag || j >= c) {
        if (sub == s) v[m] = x;
        const T o = step_operand<T, TIER>(x);
#pragma unroll
        for (int mm = m; mm < kDB / 4; ++mm)
          if (sub + 4 * mm > j)
            v[mm] = sub_rn(v[mm],
                           mul_rn(step_operand<T, TIER>(l[(sub + 4 * mm) * kDP + j]), o));
      }
    }
#pragma unroll
  for (int m = 0; m < kDB / 4; ++m) t[(sub + 4 * m) * kDP + c] = v[m];
}

// Block b of factor stage K. a (leading dimension lda) is the block; l
// receives L (leading dimension n) and holds the partial sums of the tiles
// below the diagonal until they are final; x holds those of the diagonal
// tiles. Stages 0 and 1 start from a. sa, sb, sd are shared-memory tiles.
template <typename T, int TIER>
__device__ __forceinline__ void factor_block(const T* a, long long lda, T* l, T* x, int n,
                                             int K, int b, T* sa, T* sb, T* sd) {
  const int nt = diag_tiles(n);
  const int k0 = K * kDB, kp = (K - 1) * kDB;
  T v[TM][TM];
  if (b >= nt - K) {  // a trailing block: tile (I, J), I >= J > K
    int t = b - (nt - K), J = K + 1;
    for (; t >= nt - J; ++J) t -= nt - J;  // tile column J holds nt - J of them
    const int I = J + t;
    T* part = I == J ? x : l;
    if (K == 1) {
      regs_load(v, a, lda, I * kDB, J * kDB, n, I == J);
    } else {
      regs_load(v, part, n, I * kDB, J * kDB, n, I == J);
    }
    load_tile<T, TIER, true, false>(sa, l, n, I * kDB, kp, n, false);
    load_tile<T, TIER, true, false>(sb, l, n, J * kDB, kp, n, false);
    __syncthreads();
    if (I == J) {
      apply<T, false, true>(v, sa, sb);
    } else {
      apply<T, false>(v, sa, sb);
    }
    regs_store(part, n, I * kDB, J * kDB, n, v);
    return;
  }
  const int I = K + b;  // a panel block: tile (I, K)
  const bool diag = I == K;
  T vd[TM][TM];  // the diagonal tile (K, K), which every panel block factors
  if (K <= 1) {
    regs_load(vd, a, lda, k0, k0, n, true);
    if (!diag) regs_load(v, a, lda, I * kDB, k0, n, false);
  } else {
    regs_load(vd, x, n, k0, k0, n, true);
    if (!diag) regs_load(v, l, n, I * kDB, k0, n, false);
  }
  if (K > 0) {
    load_tile<T, TIER, true, false>(sb, l, n, k0, kp, n, false);
    if (!diag) load_tile<T, TIER, true, false>(sa, l, n, I * kDB, kp, n, false);
    __syncthreads();
    apply<T, false, true>(vd, sb, sb);
    if (!diag) apply<T, false>(v, sa, sb);
    __syncthreads();
  }
  if (!diag) regs_to<false>(sa, v);
  regs_to<false>(sd, vd);
  __syncthreads();
  const int nv = min(kDB, n - k0);
  factor_diag<T, TIER>(sd, sd + kDB * kDP, nv);  // sd now holds L_KK transposed
  if (diag) {
    store_tile<true>(l, n, k0, k0, n, sd, true);
    zero_right(l, n, K, n);
    return;
  }
  solve_rows<T, TIER>(sa, sd, nv);
  __syncthreads();
  store_tile<false>(l, n, I * kDB, k0, n, sa, false);
}

// Block b of inverse stage J: l is L, x receives inv(L) (both leading
// dimension n) and holds the partial sums until they are final.
template <typename T, int TIER>
__device__ __forceinline__ void inverse_block(const T* l, T* x, int n, int J, int b, T* sa,
                                              T* sb, T* sd) {
  int I, C;
  if (b <= J) {  // a panel block: tile (J, C)
    I = J;
    C = b;
  } else {  // a trailing block: tile (I, C), I > J > C
    I = J + 1 + (b - J - 1) / J;
    C = (b - J - 1) % J;
  }
  T v[TM][TM];
  if (J <= C + 1) {  // the first stage to touch the tile: the identity's tile
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) v[i][j] = I == C && row_of(i) == col_of(j) ? T(1) : T(0);
  } else {
    regs_load(v, x, n, I * kDB, C * kDB, n, false);
  }
  if (J > C) {  // tile row J-1 of X reaches the columns C <= J-1
    load_tile<T, TIER, true, false>(sa, l, n, I * kDB, (J - 1) * kDB, n, false);
    load_tile<T, TIER, true, true>(sb, x, n, (J - 1) * kDB, C * kDB, n, false);
    __syncthreads();
    if (J - 1 == C) {
      apply<T, true>(v, sa, sb);  // x[r][c] takes only j >= c
    } else {
      apply<T, false>(v, sa, sb);
    }
  }
  if (I > J) {
    regs_store(x, n, I * kDB, C * kDB, n, v);
    return;
  }
  load_tile<T, TIER, false, false>(sd, l, n, J * kDB, J * kDB, n, true);
  __syncthreads();  // sa is read no more
  regs_to<false>(sa, v);
  __syncthreads();
  solve_cols<T, TIER>(sa, sd, min(kDB, n - J * kDB), I == C);
  __syncthreads();
  store_tile<false>(x, n, J * kDB, C * kDB, n, sa, I == C);
  if (I == C) zero_right(x, n, J, n);
}

// Launch t of the schedule: factor stage t (t < nt) in its first
// stage_blocks(nt, t) - inverse blocks, inverse stage t - 1 (t >= 1) in the
// rest. The two touch disjoint tiles: the inverse reads columns t - 2 and
// t - 1 of L, final by then, and writes tiles of x below the diagonal or in
// row t - 1, where the factor keeps no partial sum.
template <typename T, int TIER>
__global__ void __launch_bounds__(kDThreads)
diag_stage(const T* __restrict__ a, long long lda, T* l, T* x, int n, int t) {
  extern __shared__ __align__(16) unsigned char diag_smem[];
  T* sa = reinterpret_cast<T*>(diag_smem);
  T* sb = sa + kDB * kDP;
  T* sd = sb + kDB * kDP;
  const int nt = diag_tiles(n);
  const int nf = t < nt ? factor_blocks(nt, t) : 0;
  if ((int)blockIdx.x < nf) {
    factor_block<T, TIER>(a, lda, l, x, n, t, blockIdx.x, sa, sb, sd);
  } else {
    inverse_block<T, TIER>(l, x, n, t - 1, blockIdx.x - nf, sa, sb, sd);
  }
}

template <typename T, int TIER>
int launch_stages(const T* a, long long lda, T* l, T* x, int n, cudaStream_t s) {
  constexpr int smem = diag_smem_bytes<T>();
  // past 48 KB dynamic shared memory must be asked for
  int err = (int)cudaFuncSetAttribute(diag_stage<T, TIER>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int nt = diag_tiles(n);
  for (int t = 0; t <= nt && err == 0; ++t) {
    diag_stage<T, TIER><<<stage_blocks(nt, t), kDThreads, smem, s>>>(a, lda, l, x, n, t);
    err = (int)cudaGetLastError();
  }
  return err;
}

// l <- tril(L) of the nb x nb block at `panel` (leading dimension ldp, lower
// triangle read only), x <- inv(L); both nb x nb with leading dimension nb,
// zero above the diagonal. ceil(nb / 64) + 1 launches on `stream` at
// _kernel_precision of `tier`: only default differs from highest, and fp64
// has one tier. Returns the first CUDA error of the launches (a refused
// launch stops the rest), or cudaErrorInvalidValue, before any launch, for
// a block or tier the kernel does not take.
template <typename T>
int launch_diag(int tier, const T* panel, long long ldp, T* l, T* x, long long nb,
                cudaStream_t s) {
  if (nb <= 0 || nb > kMaxNb || ldp < nb || tier < kHighest || tier > kDefault)
    return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same_v<T, float>) {
    if (tier == kDefault) return launch_stages<T, kDefault>(panel, ldp, l, x, (int)nb, s);
  }
  return launch_stages<T, kHighest>(panel, ldp, l, x, (int)nb, s);
}

}  // namespace dla
