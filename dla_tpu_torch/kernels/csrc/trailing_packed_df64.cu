// The df64 trailing update over a column-slab packed pair:
// packed(hi, lo) <- packed - P * P^T on the trailing tiles of step k, in
// place on both fp32 planes, with P given as its s exact bf16 slices.
//
// Replaces dla_tpu/kernels/df64_tiles.py:trailing_update_packed_df64 (and the
// host tables it takes from pallas_tiles.py:_packed_pairs), the Pallas kernel
// of the packed emulated-fp64 POTRF, potrf_packed_df64.
//
// What it computes. Both planes have the packed layout of packed_window.cuh
// with slab width nb, which is also the panel width (the number of columns of
// each slice). At step k the trailing window is the m x m square of global
// indices base = (k+1)*nb .. n-1, cut into tb x tb tiles (tb | nb). Every
// window element (r, c) with r/tb >= c/tb goes through the compensated pass
// loop of trailing_df64.cuh (the rounding order of _df64_accum_body,
// df64_tiles.py:51-92) at its packed offset; every other element of the
// pair, the tb-tiles above the diagonal inside each diagonal nb-block
// included, is never written.
//
// Design. The reference drives a sequential TPU grid from four prefetched
// index tables. Here no table is needed: the block body is the dense df64
// kernel's tensor-core body, whose 128 x 128 blocks find their own window
// coordinates from blockIdx and return when they lie above the tb-diagonal,
// and only the offset map differs (PackedWindow, the fp32 packed kernel's;
// a block may straddle two slabs, so the map is per element). Each plane
// holds 8.6e8 elements at n = 40960, nb = 1024 and 3.4e9 at n = 81920: every
// offset is 64-bit.
//
// Bound. As the dense df64 kernel: s(s+1)/2 bf16 tensor-core products over
// the panel width for each visited element, against one read and one write
// of the pair.

#include "packed_window.cuh"
#include "trailing_df64.cuh"

// C interface, loaded with ctypes. ph and pl are the two (n(n+nb)/(2nb), nb)
// planes, slices a host array of s device pointers to the m x nb slices
// (leading dimension ldp; 16-byte aligned, ldp a multiple of 8) with m =
// n - base, base = (k+1)*nb, nt = n / nb, tb the tile of the lower-pairs
// mask, kb the exact chunk (nb a multiple of it). Returns the CUDA error of
// the first step that failed: 0 means launched.
extern "C" int dla_trailing_packed_df64(void* ph, void* pl, const void* const* slices,
                                        long long m, long long nb, long long ldp,
                                        long long base, long long nt, long long tb,
                                        long long kb, int s, int precise_deg, void* stream) {
  return dla::launch_trailing_df64(ph, pl, slices, m, nb, ldp, tb, kb, s, precise_deg,
                                   dla::PackedWindow{nb, nt, base}, stream);
}
