"""Panel kernels — counterparts of ``dla_tpu/kernels/pallas_tiles.py``:

- :func:`panel_factor` (``:270``; body ``:256``, ``_factor_lower`` ``:97``,
  ``_invert_lower`` ``:129``): one column panel of a Cholesky step, the
  diagonal block factored and inverted, every block below it solved by a
  product with the inverse. CUDA kernel ``csrc/panel_factor.cu``: the
  diagonal phase of ``csrc/diag_block.cuh``, then the product on a block
  body of the task kernels (``csrc/tile_body.cuh``), as
  :func:`panel_factor_schedule` lists.
- :func:`panel_apply` (``:429``; body ``:417``): the panel solve X·Lᵀ = B
  as a blocked TRSM over ib-wide column blocks, with the ib×ib diagonal
  inverses built outside the kernel. CUDA kernel ``csrc/panel_apply.cu``:
  the chain of products :func:`panel_apply_schedule` lists, on the block
  bodies of the task kernels (``csrc/tile_body.cuh``).

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

The products' block bodies, by tier, the same table as the task kernels'
(``tiles.tile_op_body``): the tensor-core body ``wgmma`` at fp32 ``high``
(two bf16 planes) and ``default`` (one); the fp32 FMA chain ``simt`` at
``highest``; the fp64 chain on the fp64 tensor cores ``dmma`` for fp64
(:func:`panel_factor` only: :func:`panel_apply` takes fp32). The two chain
bodies sum one fma chain per output in ascending k, the bits of the scalar
body ``tile_kernel`` (``tiles.tile_op_reference(..., tile=0)``), which no
library path launches.

``panel_factor_launches`` and ``panel_apply_launches`` count each kernel's
launches (and nothing else): a call counts one, though its C call launches
several kernels; the C side counts its calls per body
(:func:`panel_factor_body_launches`, :func:`panel_apply_body_launches`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from dla_tpu_torch.kernels import _build
from dla_tpu_torch.kernels.tiles import (
    _TIER_CODE,
    TILE_BODIES,
    _dot_nt_plain,
    _factor_lower_plain,
    _invert_lower_plain,
    _pair_shape,
    _row_major,
    _same_device,
    split_planes,
    trailing_body,
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


#: the diagonal phase's tile edge (``kDB`` of ``csrc/diag_block.cuh``): it
#: launches one stage a tile column, and one more
DIAG_TILE = 64


class PanelFactorSchedule(NamedTuple):
    """What one call of :func:`panel_factor` launches on the card: the block
    body of its tier, which its product runs and its call counts through (a
    call with m = nb has no product), the kernel launches (⌈nb/64⌉ + 1 of the
    diagonal phase, then a split and a main kernel on the tensor-core body or
    one kernel on a chain body), and the shape (rows, kpad) of the bf16 split
    scratch (None on a chain body or without a product)."""

    body: str
    launches: int
    scratch: tuple[int, int] | None


def panel_factor_body(dtype: torch.dtype, tier_name: str) -> str:
    """Which block body #4's product out[nb:] = panel[nb:]·inv(L_kk)ᵀ runs:
    ``"wgmma"`` at fp32 ``high``/``default``, ``"simt"`` at fp32 ``highest``,
    ``"dmma"`` for fp64 (``tiles.tile_op_body``'s table). ``run`` of
    ``csrc/panel_factor.cu`` dispatches on the same table."""
    if dtype not in _SUFFIX:
        raise TypeError(f"panel_factor takes float32/float64; got {dtype}")
    return trailing_body(dtype, tier_name)


def panel_factor_schedule(m: int, nb: int, dtype: torch.dtype,
                          tier_name: str) -> PanelFactorSchedule:
    """The launches of :func:`panel_factor` on an (m, nb) panel at the tier:
    the diagonal phase (⌈nb/64⌉ + 1 stages), then, where m > nb, the product
    of the m − nb rows below the block with inv(L_kk) (n = k = nb) through
    :func:`panel_factor_body`, whose split scratch on the tensor-core body
    holds both operands' planes (``tc_scratch_bytes(planes, m − nb, nb, nb)``
    of ``csrc/tile_body.cuh``, which the C call checks)."""
    body = panel_factor_body(dtype, tier_name)
    diag = -(-nb // DIAG_TILE) + 1
    if m <= nb:
        return PanelFactorSchedule(body, diag, None)
    planes = split_planes(dtype, tier_name)
    scratch = _pair_shape(m - nb, nb, nb, planes) if planes else None
    return PanelFactorSchedule(body, diag + (2 if planes else 1), scratch)


def panel_factor_body_launches() -> dict[str, int]:
    """Calls of #4's kernel in this process through the block body of their
    tier (:func:`panel_factor_body`), as the C side counts them (once a call,
    where all of its launches succeeded, also at m = nb, which has no
    product): ``{"scalar": 0, "wgmma": n, "simt": n, "dmma": n}`` (no call
    takes the scalar body); apart from the task kernels' and #3's counts.
    Needs the kernel library."""
    fn = _build.load().dla_panel_factor_body_launches
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
    return {body: fn(i) for i, body in enumerate(TILE_BODIES)}


def panel_factor(panel: torch.Tensor) -> torch.Tensor:
    """Factor a column panel [[A_kk], [A_ik…]] of shape (m, nb), m a multiple
    of nb: block 0 becomes tril(L_kk), every other block A_ik·inv(L_kk)ᵀ.
    Only the lower triangle of A_kk is read; a new (m, nb) row-major tensor
    is returned. Real float32/float64; nb ≤ 512 (the reference's VMEM
    budget, kept so both packages take the same shapes).

    On the card one C call launches on the current stream what
    :func:`panel_factor_schedule` lists: the tiled schedule of ``potrf_tile``
    factors and inverts L_kk (the inverse in a scratch tensor), then one
    product forms the rows below on the tier's block body (at fp32
    ``high``/``default`` with a split scratch allocated here).
    """
    global panel_factor_launches
    if _same_device("panel_factor", panel):
        return panel_factor_plain(panel)
    _check_panel_factor(panel)
    _row_major("panel_factor", panel)
    m, nb = panel.shape
    t = tier()
    sched = panel_factor_schedule(m, nb, panel.dtype, t)
    out = torch.empty((m, nb), dtype=panel.dtype, device=panel.device)
    linv = torch.empty((nb, nb), dtype=panel.dtype, device=panel.device)
    scratch = _split_scratch(sched, panel.device)
    nbytes = 0 if scratch is None else scratch.numel() * scratch.element_size()
    # panel, out, linv, scratch; m, nb, the panel's leading dimension, the scratch's bytes
    fn = _kernel("panel_factor", panel.dtype, 4, 4)
    with torch.cuda.device(panel.device):
        stream = torch.cuda.current_stream(panel.device).cuda_stream
        err = fn(panel.data_ptr(), out.data_ptr(), linv.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), m, nb, panel.stride(0), nbytes,
                 _TIER_CODE[t], stream)
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


class PanelProduct(NamedTuple):
    """One product of :func:`panel_apply`'s C call: ``epilogue`` "gemm" is
    the correction rhs = B_j − X[:, :col]·L[col:col+n, :col]ᵀ, "trsm" the
    product X_j = rhs·inv(L_jj)ᵀ (at col = 0 B_0 itself is the right-hand
    side); out is (m, n), the sum runs over k columns."""

    epilogue: str
    col: int
    m: int
    n: int
    k: int


class PanelApplySchedule(NamedTuple):
    """What one call of :func:`panel_apply` launches on the card: its
    products in order, the shape (rows, kpad) of the bf16 split scratch that
    the largest of them needs (None on the chain body), and the kernel
    launches (a split and a main kernel per product on the tensor-core body,
    one kernel per product on the chain body)."""

    products: tuple[PanelProduct, ...]
    scratch: tuple[int, int] | None
    launches: int


def panel_apply_planes(tier_name: str) -> int:
    """bf16 planes of each operand that #3's products take on the tensor-core
    body: fp32 ``high`` 2, ``default`` 1, ``highest`` 0 (the ``simt`` chain).
    ``dla_panel_apply_f32`` of ``csrc/panel_apply.cu`` dispatches on the same
    table."""
    return split_planes(torch.float32, tier_name)


def panel_apply_body(tier_name: str) -> str:
    """Which block body #3's products run: ``"wgmma"`` at fp32
    ``high``/``default``, ``"simt"`` at ``highest``."""
    return trailing_body(torch.float32, tier_name)


def panel_apply_body_launches() -> dict[str, int]:
    """Calls of #3's kernel in this process through each block body, as the
    C side counts them (once a call, where all of its products launched):
    ``{"scalar": 0, "wgmma": n, "simt": n}`` (no call takes the scalar
    body); apart from the task kernels' and #4's counts. Needs the kernel
    library."""
    fn = _build.load().dla_panel_apply_body_launches
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
    return {body: fn(i) for i, body in enumerate(TILE_BODIES[:3])}


def panel_apply_schedule(m: int, nb: int, ib: int, *, planes: int | None = None
                         ) -> PanelApplySchedule:
    """The products that :func:`panel_apply` launches for B (m, nb) in
    ib-wide column blocks, 2·nb/ib − 1 of them, in the order of
    ``csrc/panel_apply.cu``: for each block j, a correction over k = j·ib
    columns (j > 0), then the product with inv(L_jj) (k = ib). ``planes`` is
    the bf16 planes of the tier (default: the current tier's)."""
    if planes is None:
        planes = panel_apply_planes(tier())
    products = []
    for col in range(0, nb, ib):
        if col:
            products.append(PanelProduct("gemm", col, m, ib, col))
        products.append(PanelProduct("trsm", col, m, ib, ib))
    kmax = max(p.k for p in products)
    scratch = _pair_shape(m, ib, kmax, planes) if planes else None
    return PanelApplySchedule(tuple(products), scratch, (2 if planes else 1) * len(products))


def _split_scratch(sched: PanelApplySchedule | PanelFactorSchedule,
                   device: torch.device) -> torch.Tensor | None:
    """Uninitialised split scratch of #3's or #4's schedule (each product's
    split kernel writes its part); None on a chain body."""
    if sched.scratch is None:
        return None
    return torch.empty(sched.scratch, dtype=torch.bfloat16, device=device)


def panel_apply(lkk: torch.Tensor, b: torch.Tensor, *, ib: int = 512,
                tb: int = 1024) -> torch.Tensor:
    """Panel solve X·Lᵀ = B (``lkk`` lower triangular, (nb, nb); ``b`` (m, nb))
    as a blocked TRSM: X_j = (B_j − Σ_{i<j} X_i·L_{j,i}ᵀ)·inv(L_jj)ᵀ over the
    nb/ib column blocks j. The ib×ib inverses are built here, outside the
    kernel. Returns a new (m, nb) row-major tensor; ``b`` is only read (it may
    be a view of a wider matrix). Real float32 only; the reference's checks
    (``nb % ib``, ``tb = min(tb, m)`` dividing m) hold, though the kernel
    takes the rows whatever tb is.

    On the card one C call launches the products of
    :func:`panel_apply_schedule` on the current stream, each a grid of
    output tiles over all m rows: at fp32 ``high``/``default`` on the
    tensor-core body of the task kernels (``csrc/tile_body.cuh``, a split
    scratch reused by every product), at ``highest`` on their ``simt``
    chain.
    The right-hand side of each block lies in an (m, ib) scratch tensor.
    """
    global panel_apply_launches
    if _same_device("panel_apply", lkk, b):
        return panel_apply_plain(lkk, b, ib=ib, tb=tb)
    _check_panel_apply(lkk, b, ib, tb)
    _row_major("panel_apply", lkk, b)
    m, nb = b.shape
    t = tier()
    sched = panel_apply_schedule(m, nb, ib, planes=panel_apply_planes(t))
    dinv = _diag_inverses(lkk, ib)
    out = torch.empty((m, nb), dtype=b.dtype, device=b.device)
    rhs = torch.empty((m, ib), dtype=b.dtype, device=b.device) if nb > ib else None
    scratch = _split_scratch(sched, b.device)
    nbytes = 0 if scratch is None else scratch.numel() * scratch.element_size()
    # b, lkk, dinv, out, rhs, scratch; m, nb, ib, two leading dimensions, the scratch's bytes
    fn = _kernel("panel_apply", b.dtype, 6, 6)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = fn(b.data_ptr(), lkk.data_ptr(), dinv.data_ptr(), out.data_ptr(),
                 None if rhs is None else rhs.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), m, nb, ib, b.stride(0),
                 lkk.stride(0), nbytes, _TIER_CODE[t], stream)
    if err != 0:
        raise RuntimeError(f"panel_apply kernel launch failed: CUDA error {err}")
    panel_apply_launches += 1
    return out
