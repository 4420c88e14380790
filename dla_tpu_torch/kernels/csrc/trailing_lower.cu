// Trailing update over the lower tile pairs: C <- C - P * P^T.
//
// Replaces dla_tpu/kernels/pallas_tiles.py:trailing_update_lower (the one
// Pallas kernel on the single-device POTRF main path).
//
// What it computes. The window of C that starts at element (off, off) is cut
// into tb x tb tiles. For every tile pair (i >= j) of that window the whole
// tile, strict-upper elements of the diagonal tiles included, becomes
// C[tile] - P_i * P_j^T. Every other element of C is left untouched, so the
// update is in place and the strictly-upper tiles pass through bit for bit.
// P holds the w = m - off panel rows, row-major with leading dimension ldp.
//
// Precision, as the reference's _dot_nt (pallas_tiles.py:68-88):
//   float,  tier 0 (highest)  fp32 FMAs;
//   float,  tier 1 (high)     bf16x3: x = hi + lo with hi = bf16(x),
//                             lo = bf16(x - hi); hi*hi + (hi*lo + lo*hi),
//                             each bf16 x bf16 product exact in fp32;
//   float,  tier 2 (default)  bf16(a) * bf16(b), fp32 accumulation;
//   double                    fp64 FMAs;
//   bf16 storage              bf16 loads, fp32 accumulation, and the
//                             epilogue bf16(c - bf16(acc)) of _trailing_kernel.
//
// Design. A 2-D grid of 64 x 64 output tiles over the window; 256 threads,
// each owning 4 x 4 outputs strided by 16 so that neighbouring threads store
// neighbouring columns. A block computes its own tile indices and returns at
// once when all of it lies in tiles above the diagonal: the lower-pairs-only
// walk needs no host pair table. P's row blocks are staged through shared
// memory 16 columns of k at a time (for high, split into hi and lo once per
// load). All element offsets are 64-bit: m*m passes 2^31 at m = 46341.
//
// Bound. This is a scalar-FMA kernel, so it is bound by FMA issue and
// shared-memory reads, not by bytes: each C tile is read and written once
// while the k-loop does nb FMAs per element (three for high). Moving the
// products onto the tensor cores (wgmma, bf16 operands for the bf16x3 split,
// with TMA-fed shared-memory stages) is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;               // output tile rows = cols
constexpr int BK = 16;               // k columns staged per step
constexpr int TPB = 256;             // threads per block (16 x 16)
constexpr int TM = 4;                // outputs per thread along each axis
constexpr int LOADS = BM * BK / TPB; // elements each thread stages per operand

enum Tier { kHighest = 0, kHigh = 1, kDefault = 2 };

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float mad(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double mad(double a, double b, double c) { return __fma_rn(a, b, c); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void subtract(float* c, float upd) { *c = *c - upd; }
__device__ __forceinline__ void subtract(double* c, double upd) { *c = *c - upd; }
__device__ __forceinline__ void subtract(__nv_bfloat16* c, float upd) {
  *c = __float2bfloat16_rn(__bfloat162float(*c) - round_bf16(upd));
}

template <typename T, int TIER>
__global__ void __launch_bounds__(TPB)
trailing_lower_kernel(T* __restrict__ c, const T* __restrict__ p, long long w,
                      long long nb, long long ldc, long long ldp, long long off,
                      long long tb) {
  using A = typename AccOf<T>::type;
  constexpr bool kSplit = TIER == kHigh;
  constexpr int kPlanes = kSplit ? 2 : 1;

  const long long row0 = (long long)blockIdx.y * BM;
  const long long col0 = (long long)blockIdx.x * BM;
  const long long last_row = min(row0 + BM, w) - 1;
  if (last_row / tb < col0 / tb) return;  // every element in an upper tile

  // [plane][k][row], padded so the transposed stores do not conflict
  __shared__ A sa[kPlanes][BK][BM + 1];
  __shared__ A sb[kPlanes][BK][BM + 1];

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  A acc[TM][TM];
  A accx[TM][TM];  // high only: the two cross terms hi*lo + lo*hi
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = accx[i][j] = A(0);

  for (long long k0 = 0; k0 < nb; k0 += BK) {
#pragma unroll
    for (int e = 0; e < LOADS; ++e) {
      const int idx = threadIdx.x + e * TPB;
      const int r = idx / BK;
      const int kk = idx % BK;
      const long long k = k0 + kk;
      const long long ra = row0 + r;
      const long long rb = col0 + r;
      A va = A(0), vb = A(0);
      if (k < nb) {
        if (ra < w) va = widen(p[ra * ldp + k]);
        if (rb < w) vb = widen(p[rb * ldp + k]);
      }
      if constexpr (TIER == kHigh) {
        const float ha = round_bf16(va), hb = round_bf16(vb);
        sa[0][kk][r] = ha;
        sb[0][kk][r] = hb;
        sa[kPlanes - 1][kk][r] = round_bf16(va - ha);
        sb[kPlanes - 1][kk][r] = round_bf16(vb - hb);
      } else if constexpr (TIER == kDefault) {
        sa[0][kk][r] = round_bf16(va);
        sb[0][kk][r] = round_bf16(vb);
      } else {
        sa[0][kk][r] = va;
        sb[0][kk][r] = vb;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      A a[TM], b[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        a[i] = sa[0][kk][ty + 16 * i];
        b[i] = sb[0][kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = mad(a[i], b[j], acc[i][j]);
      if constexpr (kSplit) {
        A al[TM], bl[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          al[i] = sa[kPlanes - 1][kk][ty + 16 * i];
          bl[i] = sb[kPlanes - 1][kk][tx + 16 * i];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TM; ++j) {
            accx[i][j] = mad(a[i], bl[j], accx[i][j]);
            accx[i][j] = mad(al[i], b[j], accx[i][j]);
          }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long r = row0 + ty + 16 * i;
    if (r >= w) continue;
    const long long rtile = r / tb;
    T* crow = c + (off + r) * ldc + off;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const long long cc = col0 + tx + 16 * j;
      if (cc >= w || cc / tb > rtile) continue;
      subtract(&crow[cc], kSplit ? acc[i][j] + accx[i][j] : acc[i][j]);
    }
  }
}

template <typename T, int TIER>
int launch(void* c, const void* p, long long w, long long nb, long long ldc,
           long long ldp, long long off, long long tb, void* stream) {
  if (w <= 0) return 0;
  const long long g = (w + BM - 1) / BM;
  if (g > 65535) return (int)cudaErrorInvalidConfiguration;
  trailing_lower_kernel<T, TIER>
      <<<dim3((unsigned)g, (unsigned)g), TPB, 0, (cudaStream_t)stream>>>(
          (T*)c, (const T*)p, w, nb, ldc, ldp, off, tb);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. c is the full matrix (leading dimension
// ldc), p the panel (w x nb, leading dimension ldp), off = origin * tb. Each
// returns cudaGetLastError() after the launch; 0 means launched.
extern "C" int dla_trailing_lower_f32(void* c, const void* p, long long w,
                                      long long nb, long long ldc, long long ldp,
                                      long long off, long long tb, int tier,
                                      void* stream) {
  switch (tier) {
    case kHighest: return launch<float, kHighest>(c, p, w, nb, ldc, ldp, off, tb, stream);
    case kHigh: return launch<float, kHigh>(c, p, w, nb, ldc, ldp, off, tb, stream);
    case kDefault: return launch<float, kDefault>(c, p, w, nb, ldc, ldp, off, tb, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int dla_trailing_lower_f64(void* c, const void* p, long long w,
                                      long long nb, long long ldc, long long ldp,
                                      long long off, long long tb, int tier,
                                      void* stream) {
  (void)tier;  // fp64 has one tier
  return launch<double, kHighest>(c, p, w, nb, ldc, ldp, off, tb, stream);
}

extern "C" int dla_trailing_lower_bf16(void* c, const void* p, long long w,
                                       long long nb, long long ldc, long long ldp,
                                       long long off, long long tb, int tier,
                                       void* stream) {
  (void)tier;  // bf16 operands: every tier gives exact products
  return launch<__nv_bfloat16, kHighest>(c, p, w, nb, ldc, ldp, off, tb, stream);
}
