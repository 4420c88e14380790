"""Panel kernels — counterparts of ``dla_tpu/kernels/pallas_tiles.py``:

- :func:`panel_factor` (``:270``; body ``:256``, ``_factor_lower`` ``:97``,
  ``_invert_lower`` ``:129``): one column panel of a Cholesky step, the
  diagonal block factored and inverted, every block below it solved by a
  product with the inverse. CUDA kernel ``csrc/panel_factor.cu``.
- :func:`panel_apply` (``:429``; body ``:417``): the panel solve X·Lᵀ = B
  as a blocked TRSM over ib-wide column blocks, with the ib×ib diagonal
  inverses built outside the kernel. CUDA kernel ``csrc/panel_apply.cu``.

On a CUDA tensor each wrapper launches its hand-written Hopper kernel; on a
CPU tensor it runs its ``*_plain`` version, the same function in torch ops.
Any other device, or a CUDA tensor the kernel does not take, raises; the
wrappers never copy an operand into the layout they need.

Precision, as in the reference. The products of a panel with an inverse
(and, in :func:`panel_apply`, every product) follow the tier as
``_dot_nt`` does (``pallas_tiles.py:68-88``): bf16x3 at ``high``, one bf16
pass at ``default``, IEEE fp32 at ``highest``, fp64 for fp64. The rank-1
steps of the factor and of the inverse follow ``_kernel_precision``
(``:60-65``): ``high`` becomes ``highest``, and ``default`` multiplies
bf16-rounded operands exactly in fp32, which is what the TPU does. XLA on
the CPU ignores the precision argument, so at ``default`` the reference's
interpret-mode value is a pure fp32 one; the plain versions here keep the
TPU's semantics.

``panel_factor_launches`` and ``panel_apply_launches`` count each kernel's
launches (and nothing else).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dla_tpu_torch.kernels import _build
from dla_tpu_torch.kernels.tiles import (
    _TIER_CODE,
    _dot_nt_plain,
    _factor_lower_plain,
    _invert_lower_plain,
    _row_major,
    _same_device,
)
from dla_tpu_torch.utils.precision import tier

#: number of times each CUDA kernel was launched in this process
panel_factor_launches = 0  # panel_factor.cu
panel_apply_launches = 0  # panel_apply.cu

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


# ---- #4 panel_factor ---------------------------------------------------------------


def _check_panel_factor(panel: torch.Tensor) -> None:
    """The reference's checks (``pallas_tiles.py:276-284``) plus the dtype."""
    if panel.ndim != 2:
        raise ValueError(f"panel must be 2-D, got shape {tuple(panel.shape)}")
    m, nb = panel.shape
    if nb == 0 or m % nb:
        raise ValueError(f"panel rows {m} must be a multiple of nb={nb}")
    if panel.dtype not in _SUFFIX:
        raise TypeError(f"panel_factor takes real float32/float64 panels (the reference "
                        f"kernel is real-only); got {panel.dtype}")
    if 2 * 3 * nb * nb * panel.element_size() > 14 * 2**20:
        raise ValueError(
            f"panel_factor nb={nb} exceeds the VMEM budget (three nb×nb "
            f"buffers, pipelined); use nb ≤ 512 for float32"
        )


def panel_factor_plain(panel: torch.Tensor) -> torch.Tensor:
    """The plain torch version of :func:`panel_factor`."""
    _check_panel_factor(panel)
    nb = panel.shape[1]
    out = torch.empty(panel.shape, dtype=panel.dtype, device=panel.device)
    l = _factor_lower_plain(panel[:nb])
    out[:nb] = l
    if panel.shape[0] > nb:
        out[nb:] = _dot_nt_plain(panel[nb:], _invert_lower_plain(l)).to(panel.dtype)
    return out


@functools.cache
def _kernel(name: str, dtype: torch.dtype, npointers: int, nints: int):
    """The C entry ``dla_<name>_<dtype>``: pointers, 64-bit integers, the
    tier and the stream; it returns the CUDA error of its launches."""
    fn = getattr(_build.load(), f"dla_{name}_{_SUFFIX[dtype]}")
    fn.argtypes = ([ctypes.c_void_p] * npointers + [ctypes.c_longlong] * nints
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def panel_factor(panel: torch.Tensor) -> torch.Tensor:
    """Factor a column panel [[A_kk], [A_ik…]] of shape (m, nb), m a multiple
    of nb: block 0 becomes tril(L_kk), every other block A_ik·inv(L_kk)ᵀ.
    Only the lower triangle of A_kk is read; a new (m, nb) row-major tensor
    is returned. Real float32/float64; nb ≤ 512 (the reference's VMEM
    budget, kept so both packages take the same shapes).

    On the card one C call launches on the current stream: the tiled
    schedule of ``potrf_tile`` factors and inverts L_kk (⌈nb/64⌉ + 1 launches,
    the inverse in a scratch tensor), then a grid of 64×64 blocks forms the
    products.
    """
    global panel_factor_launches
    if _same_device("panel_factor", panel):
        return panel_factor_plain(panel)
    _check_panel_factor(panel)
    _row_major("panel_factor", panel)
    m, nb = panel.shape
    out = torch.empty((m, nb), dtype=panel.dtype, device=panel.device)
    linv = torch.empty((nb, nb), dtype=panel.dtype, device=panel.device)
    fn = _kernel("panel_factor", panel.dtype, 3, 3)
    with torch.cuda.device(panel.device):
        stream = torch.cuda.current_stream(panel.device).cuda_stream
        err = fn(panel.data_ptr(), out.data_ptr(), linv.data_ptr(), m, nb, panel.stride(0),
                 _TIER_CODE[tier()], stream)
    if err != 0:
        raise RuntimeError(f"panel_factor kernel launch failed: CUDA error {err}")
    panel_factor_launches += 1
    return out


# ---- #3 panel_apply ----------------------------------------------------------------


def _check_panel_apply(lkk: torch.Tensor, b: torch.Tensor, ib: int, tb: int) -> int:
    """The reference's checks, with its messages (``pallas_tiles.py:460-469``),
    plus the dtype the port takes; returns the clamped tb."""
    m, nb = b.shape
    if tuple(lkk.shape) != (nb, nb):
        raise ValueError(f"lkk must be ({nb},{nb}), got {tuple(lkk.shape)}")
    if nb % ib:
        raise ValueError(f"panel width {nb} must be a multiple of ib={ib}")
    tb = min(tb, m)
    if m % tb:
        raise ValueError(f"panel rows {m} must be a multiple of tb={tb}")
    if lkk.is_complex() or b.is_complex():
        raise ValueError("panel_apply is real-only; use the XLA blocktrsm")
    if lkk.dtype != torch.float32 or b.dtype != torch.float32:
        # the reference accumulates in fp32 whatever it is given (:420)
        raise TypeError(f"panel_apply takes float32 operands; got {lkk.dtype} and {b.dtype}")
    return tb


def _diag_inverses(lkk: torch.Tensor, ib: int) -> torch.Tensor:
    """The (nb, ib) stack of inv(L_jj), built outside the kernel as the
    reference does (``pallas_tiles.py:472-483``); ``cat`` makes it
    row-major whatever layout the solver returns."""
    nb = lkk.shape[0]
    eye = torch.eye(ib, dtype=lkk.dtype, device=lkk.device)
    return torch.cat([
        torch.linalg.solve_triangular(lkk[j : j + ib, j : j + ib], eye, upper=False)
        for j in range(0, nb, ib)
    ], dim=0)


def panel_apply_plain(lkk: torch.Tensor, b: torch.Tensor, *, ib: int = 512,
                      tb: int = 1024) -> torch.Tensor:
    """The plain torch version of :func:`panel_apply`: the reference's body
    over all rows at once (rows are independent)."""
    _check_panel_apply(lkk, b, ib, tb)
    nb = b.shape[1]
    dinv = _diag_inverses(lkk, ib)
    out = torch.empty(b.shape, dtype=b.dtype, device=b.device)
    for j in range(0, nb, ib):
        acc = b[:, j : j + ib].float()
        for i in range(0, j, ib):
            acc = acc - _dot_nt_plain(out[:, i : i + ib], lkk[j : j + ib, i : i + ib])
        out[:, j : j + ib] = _dot_nt_plain(acc, dinv[j : j + ib])
    return out


def panel_apply(lkk: torch.Tensor, b: torch.Tensor, *, ib: int = 512,
                tb: int = 1024) -> torch.Tensor:
    """Panel solve X·Lᵀ = B (``lkk`` lower triangular, (nb, nb); ``b`` (m, nb))
    as a blocked TRSM: X_j = (B_j − Σ_{i<j} X_i·L_{j,i}ᵀ)·inv(L_jj)ᵀ over the
    nb/ib column blocks j. The ib×ib inverses are built here, outside the
    kernel. Returns a new (m, nb) row-major tensor. Real float32 only; the
    reference's checks (``nb % ib``, ``tb = min(tb, m)`` dividing m) hold,
    though the kernel's own row strips are 64 rows whatever tb is.

    On the card one thread block owns a 64-row strip and walks j in order;
    the strip's X lives in the output and the current right-hand side in a
    scratch tensor, both in device memory.
    """
    global panel_apply_launches
    if _same_device("panel_apply", lkk, b):
        return panel_apply_plain(lkk, b, ib=ib, tb=tb)
    _check_panel_apply(lkk, b, ib, tb)
    _row_major("panel_apply", lkk, b)
    m, nb = b.shape
    dinv = _diag_inverses(lkk, ib)
    out = torch.empty((m, nb), dtype=b.dtype, device=b.device)
    rhs = torch.empty((m, ib), dtype=b.dtype, device=b.device)
    fn = _kernel("panel_apply", b.dtype, 5, 5)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = fn(b.data_ptr(), lkk.data_ptr(), dinv.data_ptr(), out.data_ptr(), rhs.data_ptr(),
                 m, nb, ib, b.stride(0), lkk.stride(0), _TIER_CODE[tier()], stream)
    if err != 0:
        raise RuntimeError(f"panel_apply kernel launch failed: CUDA error {err}")
    panel_apply_launches += 1
    return out
