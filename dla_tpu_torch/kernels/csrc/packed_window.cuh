// Where the trailing window of a packed step lives in the column-slab packed
// lower triangle; shared by the fp32 packed kernel (trailing_packed.cu) and
// the df64 one (trailing_packed_df64.cu).
//
// The packed layout (dla_tpu/algos/packed.py): an n x n lower triangle cut
// into nt = n / w column slabs; slab j holds global rows j*w .. n-1 of
// columns j*w .. (j+1)*w-1 as a dense ((nt-j)*w, w) row-major block, and the
// slabs are stacked into one (n(n+w)/(2w), w) buffer. Slab j starts at buffer
// row w * (j*nt - j*(j-1)/2). The buffer passes 2^31 elements at n = 81920,
// w = 4096 and at n = 65536, w = 1024, so the offset is 64-bit.

#pragma once

namespace dla {

// offset of element (r, c) of the trailing window of packed step k,
// base = (k+1)*w: global (R, C) = (base + r, base + c) lives in slab
// j = C / w at (row_offset(j) + R - j*w) * w + C - j*w. The map is per
// element, since a 64-wide block may straddle two slabs when w is not a
// multiple of 64.
struct PackedWindow {
  long long w, nt, base;
  __device__ __forceinline__ long long operator()(long long r, long long c) const {
    const long long row = base + r, col = base + c;
    const long long j = col / w;
    const long long slab_row0 = w * (j * nt - j * (j - 1) / 2);
    return (slab_row0 + row - j * w) * w + (col - j * w);
  }
  // the same offset split as row(r) + col(c), for an epilogue that computes
  // each once: (base + r) * w, and the rest of the slab's offset
  __device__ __forceinline__ long long row(long long r) const { return (base + r) * w; }
  __device__ __forceinline__ long long col(long long c) const {
    const long long cc = base + c;
    const long long j = cc / w;
    return (w * (j * nt - j * (j - 1) / 2) - j * w) * w + (cc - j * w);
  }
};

}  // namespace dla
