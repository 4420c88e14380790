"""Trailing update over the lower tile pairs — counterpart of
``dla_tpu/kernels/pallas_tiles.py`` (``trailing_update_lower``, ``:328``).

On a CUDA tensor :func:`trailing_update_lower` launches the hand-written
Hopper kernel in ``csrc/trailing_lower.cu``; on a CPU tensor it runs
:func:`trailing_update_lower_plain`, the same function in torch ops. Any
other device, or a CUDA tensor the kernel does not take, raises.

The reference walks a host table of lower tile pairs (``_lower_pairs``,
``:322``). Here no table is needed: each kernel block computes its own tile
indices and returns when it lies above the diagonal, and the plain version
walks the window's tile columns, one product per column.

``launches`` counts the kernel's launches (and nothing else), so a run can
show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dla_tpu_torch.kernels import _build
from dla_tpu_torch.utils.precision import tier

#: number of times the CUDA kernel was launched in this process
launches = 0

_DTYPES = (torch.float32, torch.float64, torch.bfloat16)
_TIER_CODE = {"highest": 0, "high": 1, "default": 2}
_SYMBOL = {
    torch.float32: "dla_trailing_lower_f32",
    torch.float64: "dla_trailing_lower_f64",
    torch.bfloat16: "dla_trailing_lower_bf16",
}


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
    if c.dtype not in _DTYPES or p.dtype != c.dtype:
        raise TypeError(
            "trailing_update_lower takes real float32/float64/bfloat16 c and p "
            f"of one dtype (the reference kernel is real-only); got "
            f"{c.dtype} and {p.dtype}"
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
        upd = _dot_nt_plain(p[r0:], p[r0 : r0 + tb])
        blk = out[o + r0 :, o + r0 : o + r0 + tb]
        if c.dtype == torch.bfloat16:
            blk.copy_((blk.float() - upd.to(torch.bfloat16).float()).to(torch.bfloat16))
        else:
            blk.sub_(upd)
    return out


@functools.cache
def _kernel(dtype: torch.dtype):
    fn = getattr(_build.load(), _SYMBOL[dtype])
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
    fn = _kernel(c.dtype)
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        err = fn(out.data_ptr(), p.data_ptr(), w, nb, out.stride(0), p.stride(0),
                 origin * tb, tb, _TIER_CODE[tier()], stream)
    if err != 0:
        raise RuntimeError(f"trailing_update_lower kernel launch failed: CUDA error {err}")
    launches += 1
    return out
