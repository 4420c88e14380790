"""Trailing updates C ← C − P·Pᵀ over lower tile pairs — counterparts of
``dla_tpu/kernels/pallas_tiles.py``:

- :func:`trailing_update_lower` (``:328``) on a dense matrix, CUDA kernel
  ``csrc/trailing_lower.cu``;
- :func:`trailing_update_packed` (``:557``) on the column-slab packed
  triangle of ``dla_tpu_torch.algos.packed``, CUDA kernel
  ``csrc/trailing_packed.cu``.

On a CUDA tensor each wrapper launches its hand-written Hopper kernel; on a
CPU tensor it runs its ``*_plain`` version, the same function in torch ops.
Any other device, or a CUDA tensor the kernel does not take, raises. The two
kernels share one block body (``csrc/trailing_block.cuh``) and differ only
in their address maps.

The reference walks host tables of tile pairs (``_lower_pairs``, ``:322``;
``_packed_pairs``, ``:531``). Here no table is needed: each kernel block
computes its own tile indices and returns when it lies above the diagonal,
and the plain versions walk the window's tile columns, one product per
column.

``launches`` and ``packed_launches`` count each kernel's launches (and
nothing else), so a run can show that its main path went through the
kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dla_tpu_torch.kernels import _build
from dla_tpu_torch.utils.precision import tier

#: number of times each CUDA kernel was launched in this process
launches = 0  # trailing_lower.cu
packed_launches = 0  # trailing_packed.cu

_DTYPES = (torch.float32, torch.float64, torch.bfloat16)
_TIER_CODE = {"highest": 0, "high": 1, "default": 2}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}


def _check(c: torch.Tensor, p: torch.Tensor, tb: int, kb: int | None,
           alias: bool, origin: int) -> None:
    """The reference's argument checks (``pallas_tiles.py:362-380``)."""
    if c.ndim != 2 or c.shape[0] != c.shape[1]:
        raise ValueError("c must be square")
    m = c.shape[0]
    if m % tb:
        raise ValueError(f"trailing size {m} must be a multiple of tb={tb}")
    if origin and not alias:
        raise ValueError("origin needs alias=True (untouched tiles must "
                         "pass through the output)")
    if p.ndim != 2 or p.shape[0] != m - origin * tb:
        raise ValueError("panel rows must match the trailing window")
    nb = p.shape[1]
    if kb is None:
        kb = min(nb, 512)
    if nb % kb:
        raise ValueError(f"panel width {nb} must be a multiple of kb={kb}")
    _check_dtypes("trailing_update_lower", c, p)


def _check_dtypes(name: str, c: torch.Tensor, p: torch.Tensor) -> None:
    if c.dtype not in _DTYPES or p.dtype != c.dtype:
        raise TypeError(
            f"{name} takes real float32/float64/bfloat16 operands of one dtype "
            f"(the reference kernel is real-only); got {c.dtype} and {p.dtype}"
        )


def _dot_nt_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` as the reference's ``_dot_nt``: fp32 accumulation for
    bf16/fp32 operands, bf16x3 at ``high``, one bf16 pass at ``default``."""
    if a.dtype == torch.float64:
        return a @ b.mT
    if a.dtype == torch.bfloat16:
        return a.float() @ b.float().mT
    t = tier()
    if t == "high":
        ahi = a.to(torch.bfloat16)
        alo = (a - ahi.float()).to(torch.bfloat16)
        bhi = b.to(torch.bfloat16)
        blo = (b - bhi.float()).to(torch.bfloat16)

        def dot(x, y):
            return x.float() @ y.float().mT

        return dot(ahi, bhi) + (dot(ahi, blo) + dot(alo, bhi))
    if t == "default":
        return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float().mT
    return a @ b.mT


def trailing_update_lower_plain(
    c: torch.Tensor,
    p: torch.Tensor,
    *,
    tb: int = 256,
    kb: int | None = None,
    alias: bool = True,
    origin: int = 0,
) -> torch.Tensor:
    """The plain torch version of :func:`trailing_update_lower`: one product
    per tile column of the window, over its lower tiles (diagonal tile
    whole). ``kb`` is checked but the product runs over the whole panel
    width."""
    _check(c, p, tb, kb, alias, origin)
    out = c if alias else c.clone()
    o = origin * tb
    nt = c.shape[0] // tb - origin
    for j in range(nt):
        r0 = j * tb
        _subtract(out[o + r0 :, o + r0 : o + r0 + tb], _dot_nt_plain(p[r0:], p[r0 : r0 + tb]))
    return out


def _subtract(blk: torch.Tensor, upd: torch.Tensor) -> None:
    """``blk −= upd`` in place; bf16 storage as the reference's epilogue,
    bf16(c − bf16(acc))."""
    if blk.dtype == torch.bfloat16:
        blk.copy_((blk.float() - upd.to(torch.bfloat16).float()).to(torch.bfloat16))
    else:
        blk.sub_(upd)


@functools.cache
def _kernel(kind: str, dtype: torch.dtype):
    """The C entry ``dla_trailing_<kind>_<dtype>``; both kinds take two
    pointers, six 64-bit integers, the tier and the stream."""
    fn = getattr(_build.load(), f"dla_trailing_{kind}_{_SUFFIX[dtype]}")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_longlong] * 6 + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def trailing_update_lower(
    c: torch.Tensor,
    p: torch.Tensor,
    *,
    tb: int = 256,
    kb: int | None = None,
    alias: bool = True,
    origin: int = 0,
) -> torch.Tensor:
    """C[lower tiles] ← C − P·Pᵀ over the tile pairs (i ≥ j) of the tb×tb
    grid of the window that starts at tile (origin, origin) of ``c``. Whole
    diagonal tiles are updated; every other element passes through.

    ``alias=True`` updates ``c`` in place and returns it. ``alias=False``
    leaves ``c`` alone and returns an updated copy. ``p`` has the window's
    rows, shape ``(m − origin·tb, nb)``. ``kb`` must divide nb (checked as
    in the reference); the kernel picks its own k-step. The product follows
    the precision tier at call time. Real dtypes only.
    """
    global launches
    if c.device.type == "cpu" and p.device.type == "cpu":
        return trailing_update_lower_plain(c, p, tb=tb, kb=kb, alias=alias, origin=origin)
    if c.device.type != "cuda" or p.device != c.device:
        raise ValueError(
            f"trailing_update_lower needs c and p both on the CPU or both on "
            f"one CUDA device; got {c.device} and {p.device}"
        )
    _check(c, p, tb, kb, alias, origin)
    m, nb = c.shape[0], p.shape[1]
    w = p.shape[0]
    if c.stride(1) != 1 or c.stride(0) < m or p.stride(1) != 1 or p.stride(0) < nb:
        raise ValueError(
            "trailing_update_lower needs row-major c and p (unit column "
            f"stride); got strides {c.stride()} and {p.stride()}"
        )
    out = c if alias else c.clone(memory_format=torch.contiguous_format)
    if w == 0 or nb == 0:
        return out
    fn = _kernel("lower", c.dtype)
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        err = fn(out.data_ptr(), p.data_ptr(), w, nb, out.stride(0), p.stride(0),
                 origin * tb, tb, _TIER_CODE[tier()], stream)
    if err != 0:
        raise RuntimeError(f"trailing_update_lower kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def _slab_row0(j: int, nt: int, w: int) -> int:
    """First buffer row of slab j of the packed layout (``algos/packed.py``,
    ``_row_offset``; ``csrc/trailing_packed.cu`` computes the same); slab nt
    would start at the buffer's row count."""
    return w * (j * nt - j * (j - 1) // 2)


def _check_packed(packed: torch.Tensor, p: torch.Tensor, n: int, w: int, k: int,
                  tb: int, kb: int | None) -> None:
    """The reference's argument checks (``pallas_tiles.py:582-592``), plus the
    buffer's own shape, which the kernel's address map relies on."""
    if n % w or w % tb:
        raise ValueError(f"need n % w == 0 and w % tb == 0 (n={n}, w={w}, tb={tb})")
    if not 0 <= k < n // w:  # a step outside the triangle would address outside the buffer
        raise ValueError(f"step k={k} outside 0..{n // w - 1}")
    rows = _slab_row0(n // w, n // w, w)
    if packed.shape != (rows, w):
        raise ValueError(f"packed buffer shape {tuple(packed.shape)} != {(rows, w)}")
    if tuple(p.shape) != (n - (k + 1) * w, w):
        raise ValueError(f"panel shape {tuple(p.shape)} != {(n - (k + 1) * w, w)}")
    kb = min(w, 512) if kb is None else kb
    if w % kb:
        raise ValueError(f"panel width {w} must be a multiple of kb={kb}")
    _check_dtypes("trailing_update_packed", packed, p)


def trailing_update_packed_plain(
    packed: torch.Tensor,
    p: torch.Tensor,
    *,
    n: int,
    w: int,
    k: int,
    tb: int = 1024,
    kb: int | None = None,
) -> torch.Tensor:
    """The plain torch version of :func:`trailing_update_packed`: for each tb
    tile column of the trailing window, one product from that column's
    diagonal tile down, written into the owning slab. The diagonal tile is
    updated whole; the tiles above it inside a diagonal w-block are left
    alone. ``kb`` is checked but the product runs over the whole panel
    width.

    This is not ``potrf_packed(trailing="xla")``'s per-slab loop, which
    updates each whole w×w diagonal block: the two differ above the
    tb-diagonal."""
    _check_packed(packed, p, n, w, k, tb, kb)
    nt = n // w
    base = (k + 1) * w
    for c0 in range(0, n - base, tb):
        j, cs = divmod(base + c0, w)  # owning slab, column inside it
        r0 = _slab_row0(j, nt, w) + cs  # buffer row of global row base + c0
        upd = _dot_nt_plain(p[c0:], p[c0 : c0 + tb])
        _subtract(packed[r0 : r0 + upd.shape[0], cs : cs + tb], upd)
    return packed


def trailing_update_packed(
    packed: torch.Tensor,
    p: torch.Tensor,
    *,
    n: int,
    w: int,
    k: int,
    tb: int = 1024,
    kb: int | None = None,
) -> torch.Tensor:
    """packed[trailing tiles] ← packed − P·Pᵀ over the column-slab packed
    lower triangle (``dla_tpu_torch.algos.packed`` layout), **in place**:
    ``packed`` is updated and returned (the reference aliases input and
    output to the same effect).

    ``w`` is the slab width, ``k`` the panel step in slab units, ``p`` the
    solved panel of the trailing rows, shape ``(n − (k+1)·w, w)``, in the
    buffer's dtype. The trailing window is cut into tb×tb tiles; the lower
    tile pairs are updated (diagonal tiles whole), every other element
    passes through bit for bit. ``kb`` must divide w (checked as in the
    reference); the kernel picks its own k-step. The product follows the
    precision tier at call time. Real dtypes only.
    """
    global packed_launches
    if packed.device.type == "cpu" and p.device.type == "cpu":
        return trailing_update_packed_plain(packed, p, n=n, w=w, k=k, tb=tb, kb=kb)
    if packed.device.type != "cuda" or p.device != packed.device:
        raise ValueError(
            f"trailing_update_packed needs packed and p both on the CPU or both "
            f"on one CUDA device; got {packed.device} and {p.device}"
        )
    _check_packed(packed, p, n, w, k, tb, kb)
    if not packed.is_contiguous() or p.stride(1) != 1 or p.stride(0) < w:
        raise ValueError(
            "trailing_update_packed needs a contiguous row-major packed buffer and "
            f"a row-major panel; got strides {packed.stride()} and {p.stride()}"
        )
    m = p.shape[0]
    if m == 0:
        return packed
    fn = _kernel("packed", packed.dtype)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        err = fn(packed.data_ptr(), p.data_ptr(), m, w, p.stride(0), (k + 1) * w, n // w,
                 tb, _TIER_CODE[tier()], stream)
    if err != 0:
        raise RuntimeError(f"trailing_update_packed kernel launch failed: CUDA error {err}")
    packed_launches += 1
    return packed
