"""The df64 trailing updates (C_hi, C_lo) ← C − P·Pᵀ over lower tile pairs —
counterparts of ``dla_tpu/kernels/df64_tiles.py``: ``trailing_update_df64``
(``:110``) on a dense pair and ``trailing_update_packed_df64`` (``:185``) on a
column-slab packed pair.

P arrives as its ``s`` exact bf16 slices (:func:`dla_tpu_torch.ops.df64.slice_rows`).
For each k-chunk of ``kb = min(nb, 2^(26−2w))`` columns and each slice pair
(i, j), j < s − i, in that order, the pair's product over the chunk is exact
in fp32 whatever the order of its sum; it is subtracted from the hi plane with
a compensated ``two_sum`` when i + j ≤ ``precise_deg`` and from the lo plane
plainly otherwise, and one ``quick_two_sum`` renormalizes the pair after the
last chunk. The rounding steps run in a fixed order, so the CUDA kernel and the
plain version give the same bits.

On CUDA tensors :func:`trailing_update_df64` launches the hand-written Hopper
kernel ``csrc/trailing_df64.cu`` and :func:`trailing_update_packed_df64`
launches ``csrc/trailing_packed_df64.cu`` (one tensor-core block body,
``csrc/trailing_df64.cuh``, with two offset maps: each chunk product is a
``wgmma`` sum, exact because every partial sum lies on the pair's grid); on CPU
tensors they run :func:`trailing_update_df64_plain` and
:func:`trailing_update_packed_df64_plain`, the same functions in torch ops. Any
other device, or a CUDA tensor the kernel does not take, raises. The kernel
reads each slice through a TMA tensor map; slices TMA cannot address (a row
stride that is not a multiple of 16 bytes) are first copied into a padded
scratch. ``launches`` and ``packed_launches`` count each kernel's launches and
nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dla_tpu_torch.kernels import _build
from dla_tpu_torch.kernels.tiles import _slab_row0
from dla_tpu_torch.ops.df64 import max_exact_chunk, quick_two_sum, two_sum

#: number of times the CUDA kernel (trailing_df64.cu) was launched in this process
launches = 0

#: number of times the packed CUDA kernel (trailing_packed_df64.cu) was launched
packed_launches = 0

#: most slices the kernels take (``DF64_MAX_SLICES`` in ``csrc/trailing_df64.cuh``)
MAX_SLICES = 8

#: columns of k the kernels' tensor-core body reads per stage (``kBK`` in
#: ``csrc/trailing_wgmma.cuh``): a chunk shorter than the panel must be a multiple
K_STEP = 64


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
    h = slices[0].shape[0]
    if h != m - origin * tb:
        raise ValueError(f"slice rows {h} != trailing window {m - origin * tb}")
    return _check_slices(ch, cl, slices, w)


def _check_slices(ch, cl, slices, w: int) -> int:
    """What both updates ask of the slices and of the pair's dtype; returns
    the chunk length kb."""
    nb = slices[0].shape[1]
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


def _pass_loop(ah, al, f, r0: int, tb: int, kb: int, precise_deg: int):
    """The compensated pass loop of one tb tile column, from its diagonal tile
    down: (ah, al) are the column's current values, ``f`` the fp32-upcast
    slices, ``r0`` the column's first window row. Returns the renormalized
    pair."""
    s = len(f)
    for k0 in range(0, f[0].shape[1], kb):
        for i in range(s):
            for j in range(s - i):
                p = f[i][r0:, k0 : k0 + kb] @ f[j][r0 : r0 + tb, k0 : k0 + kb].mT
                if i + j <= precise_deg:
                    ah, e = two_sum(ah, -p)
                    al = al + e
                else:
                    al = al - p
    return quick_two_sum(ah, al)


def _cuda_slices(name: str, pair, slices, kb: int):
    """The CUDA wrappers' device and slice-layout checks; returns the slices
    the kernel reads (the given ones, or their copy in a padded scratch where
    TMA cannot address them), their leading dimension and the host array of
    their device pointers. Keep the slices alive until the launch is queued."""
    ch = pair[0]
    tensors = (*pair, *slices)
    if ch.device.type != "cuda" or any(t.device != ch.device for t in tensors):
        raise ValueError(
            f"{name} needs the pair and the slices all on the CPU or "
            f"all on one CUDA device; got {sorted({str(t.device) for t in tensors})}"
        )
    if len(slices) > MAX_SLICES:
        raise ValueError(f"the kernel takes at most {MAX_SLICES} slices; got {len(slices)}")
    h, nb = slices[0].shape
    ldp = slices[0].stride(0)
    if any(x.stride() != (ldp, 1) for x in slices) or ldp < nb:
        raise ValueError(f"{name} needs row-major slices with one stride; got "
                         f"{[x.stride() for x in slices]}")
    if kb < nb and kb % K_STEP:
        raise ValueError(f"{name}: a chunk of {kb} columns (w too large) is not a multiple of "
                         f"the kernel's {K_STEP}-column k-step")
    if ldp % 8 or any(x.data_ptr() % 16 for x in slices):
        ldp = -(-nb // 8) * 8  # TMA: 16-byte aligned rows
        pad = torch.empty((len(slices), h, ldp), dtype=torch.bfloat16, device=ch.device)
        slices = [pad[t, :, :nb].copy_(x) for t, x in enumerate(slices)]
    return slices, ldp, (ctypes.c_void_p * len(slices))(*[x.data_ptr() for x in slices])


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
    f = [x.to(torch.float32) for x in slices]  # bf16 values, exact in fp32
    o = origin * tb
    for r0 in range(0, f[0].shape[0], tb):
        rows, cols = slice(o + r0, None), slice(o + r0, o + r0 + tb)
        hi, lo = _pass_loop(ch[rows, cols], cl[rows, cols], f, r0, tb, kb, precise_deg)
        ch[rows, cols] = hi
        cl[rows, cols] = lo
    return ch, cl


@functools.cache
def _kernel(name: str):
    """A C entry of the two df64 kernels, ``dla_trailing_df64`` or
    ``dla_trailing_packed_df64``: two plane pointers, an array of slice
    pointers, seven 64-bit integers, two ints and the stream."""
    fn = getattr(_build.load(), name)
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
    kb = _check(ch, cl, slices, origin, tb, w)
    slices, ldp, ptrs = _cuda_slices("trailing_update_df64", (ch, cl), slices, kb)
    m = ch.shape[0]
    h, nb = slices[0].shape
    if ch.stride() != cl.stride() or ch.stride(1) != 1 or ch.stride(0) < m:
        raise ValueError(f"trailing_update_df64 needs two row-major planes with one stride; "
                         f"got {ch.stride()} and {cl.stride()}")
    if h == 0 or nb == 0:
        return ch, cl
    with torch.cuda.device(ch.device):
        stream = torch.cuda.current_stream(ch.device).cuda_stream
        err = _kernel("dla_trailing_df64")(
            ch.data_ptr(), cl.data_ptr(), ptrs, h, nb, ch.stride(0), ldp, origin * tb, tb, kb,
            len(slices), precise_deg, stream)
    if err != 0:
        raise RuntimeError(f"trailing_update_df64 kernel launch failed: CUDA error {err}")
    launches += 1
    return ch, cl


def _check_packed(ph: torch.Tensor, pl: torch.Tensor, slices, n: int, nb: int, k: int,
                  tb: int, w: int) -> int:
    """The reference's argument checks (``df64_tiles.py:211-223``), plus the
    step range, the planes' own shape (the offset map relies on both) and the
    dtypes; returns the chunk length kb."""
    if pl.shape != ph.shape:
        raise ValueError("packed pair planes must match")
    if n % nb or nb % tb:
        raise ValueError(f"need tb | nb | n (n={n}, nb={nb}, tb={tb})")
    if not 0 <= k < n // nb:  # a step outside the triangle would address outside the planes
        raise ValueError(f"step k={k} outside 0..{n // nb - 1}")
    rows = _slab_row0(n // nb, n // nb, nb)
    if ph.shape != (rows, nb):
        raise ValueError(f"packed plane shape {tuple(ph.shape)} != {(rows, nb)}")
    if not slices:
        raise ValueError("need at least one slice")
    if tuple(slices[0].shape) != (n - (k + 1) * nb, nb):
        raise ValueError(f"slice shape {tuple(slices[0].shape)} != {(n - (k + 1) * nb, nb)}")
    return _check_slices(ph, pl, slices, w)


def trailing_update_packed_df64_plain(
    ph: torch.Tensor,
    pl: torch.Tensor,
    slices: list[torch.Tensor],
    *,
    n: int,
    nb: int,
    k: int,
    tb: int = 512,
    w: int = 8,
    precise_deg: int = 3,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain torch version of :func:`trailing_update_packed_df64`: for
    each tb tile column of the trailing window, the pass loop of
    :func:`trailing_update_df64_plain` from that column's diagonal tile down,
    written into the owning slab of both planes. The diagonal tile is updated
    whole; the tiles above it inside a diagonal nb-block are left alone.
    Updates both planes in place and returns them."""
    kb = _check_packed(ph, pl, slices, n, nb, k, tb, w)
    f = [x.to(torch.float32) for x in slices]  # bf16 values, exact in fp32
    nt = n // nb
    base = (k + 1) * nb
    for c0 in range(0, n - base, tb):
        j, cs = divmod(base + c0, nb)  # owning slab, column inside it
        r0 = _slab_row0(j, nt, nb) + cs  # plane row of global row base + c0
        rows, cols = slice(r0, r0 + n - base - c0), slice(cs, cs + tb)
        hi, lo = _pass_loop(ph[rows, cols], pl[rows, cols], f, c0, tb, kb, precise_deg)
        ph[rows, cols] = hi
        pl[rows, cols] = lo
    return ph, pl


def trailing_update_packed_df64(
    ph: torch.Tensor,
    pl: torch.Tensor,
    slices: list[torch.Tensor],
    *,
    n: int,
    nb: int,
    k: int,
    tb: int = 512,
    w: int = 8,
    precise_deg: int = 3,
) -> tuple[torch.Tensor, torch.Tensor]:
    """packed(hi, lo)[trailing tiles of step k] ← packed − P·Pᵀ over a
    column-slab packed pair (``dla_tpu_torch.algos.packed`` layout), P given
    as its ``s`` exact bf16 slices: the pass loop of
    :func:`trailing_update_df64` at the packed offsets. **In place** on both
    fp32 planes, which are returned (the reference aliases them to the same
    effect).

    ``nb`` is the slab width *and* the panel width (each slice is
    ``(n − (k+1)·nb, nb)``), ``k`` the slab step, ``tb`` the tile of the
    lower-pairs mask (``tb | nb | n``), ``w`` the bits per slice. The lower tile
    pairs of the trailing window are updated, diagonal tb-tiles whole; every
    other element, the tb-tiles above the diagonal inside each diagonal
    nb-block included, passes through bit for bit.
    """
    global packed_launches
    if all(t.device.type == "cpu" for t in (ph, pl, *slices)):
        return trailing_update_packed_df64_plain(ph, pl, slices, n=n, nb=nb, k=k, tb=tb, w=w,
                                                 precise_deg=precise_deg)
    kb = _check_packed(ph, pl, slices, n, nb, k, tb, w)
    slices, ldp, ptrs = _cuda_slices("trailing_update_packed_df64", (ph, pl), slices, kb)
    if not ph.is_contiguous() or not pl.is_contiguous():
        raise ValueError("trailing_update_packed_df64 needs two contiguous row-major planes; "
                         f"got strides {ph.stride()} and {pl.stride()}")
    m = slices[0].shape[0]
    if m == 0:
        return ph, pl
    with torch.cuda.device(ph.device):
        stream = torch.cuda.current_stream(ph.device).cuda_stream
        err = _kernel("dla_trailing_packed_df64")(
            ph.data_ptr(), pl.data_ptr(), ptrs, m, nb, ldp, (k + 1) * nb, n // nb, tb, kb,
            len(slices), precise_deg, stream)
    if err != 0:
        raise RuntimeError(f"trailing_update_packed_df64 kernel launch failed: CUDA error {err}")
    packed_launches += 1
    return ph, pl
