// The block body shared by the two df64 trailing-update kernels:
// (C_hi, C_lo) <- C - P * P^T over the lower tile pairs of a square window,
// in place on both fp32 planes, with P given as its s exact bf16 slices.
//
// trailing_df64.cu writes the window into a dense pair, trailing_packed_df64.cu
// into a column-slab packed pair. They differ only in where element (r, c) of
// the window lives, so the kernel is here once, templated on an offset functor
// Addr(r, c) -> long long (the element's offset, the same in both planes), as
// trailing_block.cuh is for the fp32 kernels.
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
// and every other element is never written. The slices put each row on a
// power-of-2 grid with at most w significant bits per slice, so every product
// is exact in fp32 and so is every partial sum of up to 2^(26-2w) of them: p
// comes out the same whatever the k order, the tiling or the use of FMA. Only
// the (i, j) order and the compensation steps round, and those are written
// with __fadd_rn/__fsub_rn, which nvcc never contracts or reorders (and -ftz
// stays off: the slices are normal-range by construction). So the kernel
// gives the same bits as the plain torch versions, trailing_update_df64_plain
// and trailing_update_packed_df64_plain.
//
// Design. The output-block grid, the early return of blocks wholly above the
// diagonal (no host pair table), the per-element mask and the 256-thread
// 4 x 4-output layout are those of trailing_block.cuh. Each thread holds hi,
// lo and one pair accumulator p for its 16 outputs. Pairs run in the outer
// loop; for each pair, P_i's and P_j's row blocks are staged through shared
// memory BK columns at a time and widened from bf16 to fp32. All element
// offsets are 64-bit (a dense plane passes 2^31 elements at m = 46341, a
// packed one with 1024-wide slabs at n = 65536).
//
// Bound. Scalar FMAs and shared-memory reads, s(s+1)/2 passes (28 at s = 7)
// over the panel width for each output: the C pair is read and written once
// per call. The later design moves the passes onto the tensor cores: bf16
// wgmma products of these slices are exact; whether Hopper's tensor-core fp32
// accumulation of a 1024-product chunk is exact too is to be tested, and if
// it is, a tensor-core version gives the same bits.

#pragma once

#include "trailing_block.cuh"

#define DF64_MAX_SLICES 8

namespace dla {

struct Slices {
  const __nv_bfloat16* p[DF64_MAX_SLICES];
};

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float v = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, v)), __fsub_rn(b, v));
}

// addr is a __grid_constant__: read where the launch put it instead of being
// copied per thread. Measured on an H100 at m = 24576, tb = 512, nb = 1024,
// s = 7, the dense kernel takes 1154 ms with it and 1287 ms without.
template <typename Addr>
__global__ void __launch_bounds__(TPB)
trailing_df64_kernel(float* __restrict__ ch, float* __restrict__ cl, Slices sl, long long w,
                     long long nb, long long ldp, long long tb, long long kb, int s,
                     int precise_deg, const __grid_constant__ Addr addr) {
  const long long row0 = (long long)blockIdx.y * BM;
  const long long col0 = (long long)blockIdx.x * BM;
  const long long last_row = min(row0 + BM, w) - 1;
  if (last_row / tb < col0 / tb) return;  // every element in an upper tile

  // [k][row], padded so the transposed stores do not conflict
  __shared__ float sa[BK][BM + 1];
  __shared__ float sb[BK][BM + 1];

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float hi[TM][TM], lo[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long r = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const long long c = col0 + tx + 16 * j;
      hi[i][j] = lo[i][j] = 0.f;
      if (r < w && c < w && c / tb <= r / tb) {
        const long long idx = addr(r, c);
        hi[i][j] = ch[idx];
        lo[i][j] = cl[idx];
      }
    }
  }

  for (long long ks = 0; ks < nb; ks += kb) {
    const long long kend = ks + kb;
    for (int pi = 0; pi < s; ++pi) {
      for (int pj = 0; pj < s - pi; ++pj) {
        const __nv_bfloat16* pa = sl.p[pi];
        const __nv_bfloat16* pb = sl.p[pj];
        float acc[TM][TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;

        for (long long k0 = ks; k0 < kend; k0 += BK) {
#pragma unroll
          for (int e = 0; e < LOADS; ++e) {
            const int idx = threadIdx.x + e * TPB;
            const int r = idx / BK;
            const int kk = idx % BK;
            const long long k = k0 + kk;
            const long long ra = row0 + r;
            const long long rb = col0 + r;
            float va = 0.f, vb = 0.f;
            if (k < kend) {
              if (ra < w) va = widen(pa[ra * ldp + k]);
              if (rb < w) vb = widen(pb[rb * ldp + k]);
            }
            sa[kk][r] = va;
            sb[kk][r] = vb;
          }
          __syncthreads();
#pragma unroll
          for (int kk = 0; kk < BK; ++kk) {
            float a[TM], b[TM];
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              a[i] = sa[kk][ty + 16 * i];
              b[i] = sb[kk][tx + 16 * i];
            }
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int j = 0; j < TM; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
          }
          __syncthreads();
        }

        if (pi + pj <= precise_deg) {
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TM; ++j) {
              float sum, err;
              two_sum(hi[i][j], -acc[i][j], sum, err);
              hi[i][j] = sum;
              lo[i][j] = __fadd_rn(lo[i][j], err);
            }
        } else {
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TM; ++j) lo[i][j] = __fsub_rn(lo[i][j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long r = row0 + ty + 16 * i;
    if (r >= w) continue;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const long long c = col0 + tx + 16 * j;
      if (c >= w || c / tb > r / tb) continue;
      // quick_two_sum(hi, lo)
      const float sum = __fadd_rn(hi[i][j], lo[i][j]);
      const float err = __fsub_rn(lo[i][j], __fsub_rn(sum, hi[i][j]));
      const long long idx = addr(r, c);
      ch[idx] = sum;
      cl[idx] = err;
    }
  }
}

// Launch the kernel over a w x w window on `stream`. slices is a host array
// of s device pointers to the w x nb slices (leading dimension ldp), kb the
// exact chunk (nb a multiple of it). Returns cudaGetLastError() after the
// launch: 0 means launched.
template <typename Addr>
int launch_trailing_df64(void* ch, void* cl, const void* const* slices, long long w,
                         long long nb, long long ldp, long long tb, long long kb, int s,
                         int precise_deg, Addr addr, void* stream) {
  if (s < 1 || s > DF64_MAX_SLICES || kb < 1 || tb < 1) return (int)cudaErrorInvalidValue;
  if (w <= 0 || nb <= 0) return 0;
  const long long g = (w + BM - 1) / BM;
  if (g > 65535) return (int)cudaErrorInvalidConfiguration;
  Slices sl{};
  for (int t = 0; t < s; ++t) sl.p[t] = (const __nv_bfloat16*)slices[t];
  const dim3 grid((unsigned)g, (unsigned)g);
  trailing_df64_kernel<Addr><<<grid, TPB, 0, (cudaStream_t)stream>>>(
      (float*)ch, (float*)cl, sl, w, nb, ldp, tb, kb, s, precise_deg, addr);
  return (int)cudaGetLastError();
}

}  // namespace dla
