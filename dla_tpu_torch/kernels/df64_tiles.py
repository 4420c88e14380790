"""The df64 trailing update (C_hi, C_lo) ← C − P·Pᵀ over lower tile pairs —
counterpart of ``dla_tpu/kernels/df64_tiles.py:trailing_update_df64``
(``:110``).

P arrives as its ``s`` exact bf16 slices (:func:`dla_tpu_torch.ops.df64.slice_rows`).
For each k-chunk of ``kb = min(nb, 2^(26−2w))`` columns and each slice pair
(i, j), j < s − i, in that order, the pair's product over the chunk is exact
in fp32 whatever the order of its sum; it is subtracted from the hi plane with
a compensated ``two_sum`` when i + j ≤ ``precise_deg`` and from the lo plane
plainly otherwise, and one ``quick_two_sum`` renormalizes the pair after the
last chunk. The rounding steps run in a fixed order, so the CUDA kernel and the
plain version give the same bits.

On a CUDA tensor :func:`trailing_update_df64` launches the hand-written Hopper
kernel ``csrc/trailing_df64.cu``; on a CPU tensor it runs
:func:`trailing_update_df64_plain`, the same function in torch ops. Any other
device, or a CUDA tensor the kernel does not take, raises. ``launches`` counts
the kernel's launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dla_tpu_torch.kernels import _build
from dla_tpu_torch.ops.df64 import max_exact_chunk, quick_two_sum, two_sum

#: number of times the CUDA kernel (trailing_df64.cu) was launched in this process
launches = 0

#: most slices the kernel takes (``DF64_MAX_SLICES`` in ``csrc/trailing_df64.cu``)
MAX_SLICES = 8


def _check(ch: torch.Tensor, cl: torch.Tensor, slices, origin: int, tb: int,
           w: int) -> int:
    """The reference's argument checks (``df64_tiles.py:127-139``) plus the
    dtypes; returns the chunk length kb."""
    if ch.ndim != 2 or ch.shape[0] != ch.shape[1] or cl.shape != ch.shape:
        raise ValueError("C pair must be square and matching")
    m = ch.shape[0]
    if m % tb:
        raise ValueError(f"m={m} must be a multiple of tb={tb}")
    if not slices:
        raise ValueError("need at least one slice")
    h, nb = slices[0].shape
    if h != m - origin * tb:
        raise ValueError(f"slice rows {h} != trailing window {m - origin * tb}")
    if any(x.shape != slices[0].shape for x in slices):
        raise ValueError("slices must share one shape")
    kb = min(nb, max_exact_chunk(w))
    if nb % kb:
        raise ValueError(f"panel width {nb} not a multiple of chunk {kb}")
    if ch.dtype != torch.float32 or cl.dtype != torch.float32:
        raise TypeError(f"the C pair must be float32; got {ch.dtype} and {cl.dtype}")
    if any(x.dtype != torch.bfloat16 for x in slices):
        raise TypeError("the slices must be bfloat16 (slice_rows output)")
    return kb


def trailing_update_df64_plain(
    ch: torch.Tensor,
    cl: torch.Tensor,
    slices: list[torch.Tensor],
    *,
    origin: int = 0,
    tb: int = 512,
    w: int = 8,
    precise_deg: int = 3,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain torch version of :func:`trailing_update_df64`: for each tb
    tile column of the window, from its diagonal tile down, one fp32 product
    per k-chunk and slice pair, compensated in the kernel's order. Updates
    both planes in place and returns them."""
    kb = _check(ch, cl, slices, origin, tb, w)
    s = len(slices)
    f = [x.to(torch.float32) for x in slices]  # bf16 values, exact in fp32
    h, nb = f[0].shape
    o = origin * tb
    for r0 in range(0, h, tb):
        rows, cols = slice(o + r0, None), slice(o + r0, o + r0 + tb)
        ah, al = ch[rows, cols], cl[rows, cols]
        for k0 in range(0, nb, kb):
            for i in range(s):
                for j in range(s - i):
                    p = f[i][r0:, k0 : k0 + kb] @ f[j][r0 : r0 + tb, k0 : k0 + kb].mT
                    if i + j <= precise_deg:
                        ah, e = two_sum(ah, -p)
                        al = al + e
                    else:
                        al = al - p
        hi, lo = quick_two_sum(ah, al)
        ch[rows, cols] = hi
        cl[rows, cols] = lo
    return ch, cl


@functools.cache
def _kernel():
    """The C entry ``dla_trailing_df64``: two plane pointers, an array of
    slice pointers, seven 64-bit integers, two ints and the stream."""
    fn = _build.load().dla_trailing_df64
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
                   + [ctypes.c_longlong] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def trailing_update_df64(
    ch: torch.Tensor,
    cl: torch.Tensor,
    slices: list[torch.Tensor],
    *,
    origin: int = 0,
    tb: int = 512,
    w: int = 8,
    precise_deg: int = 3,
) -> tuple[torch.Tensor, torch.Tensor]:
    """C(hi, lo)[lower trailing tiles] ← C − P·Pᵀ, P given as its ``s`` exact
    bf16 slices (:func:`dla_tpu_torch.ops.df64.slice_rows`), over the tile
    pairs (i ≥ j) of the tb×tb grid of the window that starts at tile
    (origin, origin) of the (m, m) pair. **In place** on both fp32 planes,
    which are returned (the reference aliases them to the same effect). Whole
    diagonal tiles are updated; every other element passes through bit for
    bit. Each slice has the window's rows, shape ``(m − origin·tb, nb)``.
    """
    global launches
    tensors = (ch, cl, *slices)
    if all(t.device.type == "cpu" for t in tensors):
        return trailing_update_df64_plain(ch, cl, slices, origin=origin, tb=tb, w=w,
                                          precise_deg=precise_deg)
    if ch.device.type != "cuda" or any(t.device != ch.device for t in tensors):
        raise ValueError(
            "trailing_update_df64 needs the pair and the slices all on the CPU or "
            f"all on one CUDA device; got {sorted({str(t.device) for t in tensors})}"
        )
    kb = _check(ch, cl, slices, origin, tb, w)
    m = ch.shape[0]
    h, nb = slices[0].shape
    if len(slices) > MAX_SLICES:
        raise ValueError(f"the kernel takes at most {MAX_SLICES} slices; got {len(slices)}")
    if ch.stride() != cl.stride() or ch.stride(1) != 1 or ch.stride(0) < m:
        raise ValueError(f"trailing_update_df64 needs two row-major planes with one stride; "
                         f"got {ch.stride()} and {cl.stride()}")
    ldp = slices[0].stride(0)
    if any(x.stride() != (ldp, 1) for x in slices) or ldp < nb:
        raise ValueError("trailing_update_df64 needs row-major slices with one stride; got "
                         f"{[x.stride() for x in slices]}")
    if h == 0 or nb == 0:
        return ch, cl
    ptrs = (ctypes.c_void_p * len(slices))(*[x.data_ptr() for x in slices])
    with torch.cuda.device(ch.device):
        stream = torch.cuda.current_stream(ch.device).cuda_stream
        err = _kernel()(ch.data_ptr(), cl.data_ptr(), ptrs, h, nb, ch.stride(0), ldp,
                        origin * tb, tb, kb, len(slices), precise_deg, stream)
    if err != 0:
        raise RuntimeError(f"trailing_update_df64 kernel launch failed: CUDA error {err}")
    launches += 1
    return ch, cl
