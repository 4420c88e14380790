"""Residual gate and numerical invariants — counterpart of
``dla_tpu/validate/residual.py``.

The reference's numerical contract (``v6_test.c:70-87``): a driver checks
``||A − L·Lᵀ||_inf / ||A||_inf < 1e-10`` and prints PASS/FAIL. As in the
JAX package, A is symmetrized from its lower triangle before both the
subtraction and the denominator norm, so the gate is meetable.

The residual is computed in float64 (complex128) on every device: the H100
has native fp64, and the JAX package's tests run under x64.

:func:`freivalds_device` is the matrix-free gate for factors of seeded
``plgsy`` matrices where A, L and their fp64 copies do not fit together: A is
regenerated from its seed one row slab at a time.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dla_tpu_torch.ops import lange, plgsy_tile
from dla_tpu_torch.ops.lapack_like import _C1, _MASK, _mix32

#: The reference's PASS threshold (``v6_test.c:87``).
PASS_THRESHOLD = 1e-10


def _symmetrize_lower(a: torch.Tensor) -> torch.Tensor:
    return torch.tril(a) + torch.tril(a, -1).conj().mT


def residual_potrf(
    a: torch.Tensor,
    l: torch.Tensor,
    *,
    norm: str = "I",
    assume_symmetric: bool = False,
    assume_tril: bool = False,
    row_chunk: int | None = None,
) -> torch.Tensor:
    """Relative factorization residual ``||A − L·Lᵀ||_inf / ||A||_inf``.

    ``a`` may carry garbage in its strict upper triangle; it is symmetrized
    from the lower triangle unless ``assume_symmetric``. Only ``tril(l)`` is
    used (``assume_tril`` skips the mask when the caller guarantees it).

    ``row_chunk`` computes the norm over (row_chunk, n) row slabs instead of
    one N² reconstruction (``norm`` 'I' or 'M', n divisible by row_chunk).
    With bf16/fp16 storage in that form the N² operands stay in storage
    precision and are widened one (row_chunk × n) slab at a time.
    """
    wide = torch.complex128 if a.is_complex() else torch.float64
    low_storage = row_chunk is not None and a.dtype in (torch.bfloat16, torch.float16)
    if low_storage:
        aa = a if assume_symmetric else _symmetrize_lower(a)
        ll = l if assume_tril else torch.tril(l)
    else:
        aw = a.to(wide)
        aa = aw if assume_symmetric else _symmetrize_lower(aw)
        ll = l.to(wide) if assume_tril else torch.tril(l).to(wide)
    if row_chunk is None:
        rec = ll @ ll.conj().mT
        return lange(norm, aa - rec) / lange(norm, aa)
    n = a.shape[-1]
    if norm.upper() not in ("I", "M"):
        raise ValueError("row_chunk supports norm='I'/'M' only")
    if n % row_chunk:
        raise ValueError(f"n={n} must be a multiple of row_chunk={row_chunk}")
    maxnorm = norm.upper() == "M"
    num = torch.zeros((), dtype=torch.float64, device=a.device)
    den = torch.zeros((), dtype=torch.float64, device=a.device)
    for r0 in range(0, n, row_chunk):
        arow = aa[r0 : r0 + row_chunk].to(wide)
        lrow = ll[r0 : r0 + row_chunk].to(wide)
        rec = torch.cat(
            [lrow @ ll[c0 : c0 + row_chunk].to(wide).conj().mT
             for c0 in range(0, n, row_chunk)],
            dim=1,
        )
        dif = torch.abs(arow - rec)
        absa = torch.abs(arow)
        if maxnorm:
            num = torch.maximum(num, dif.max())
            den = torch.maximum(den, absa.max())
        else:
            num = torch.maximum(num, dif.sum(dim=1).max())
            den = torch.maximum(den, absa.sum(dim=1).max())
    return num / den


def _probe_vec(n: int, seed: int, device) -> torch.Tensor:
    """The native runtime's Freivalds probe vector (``tilestore.cpp``
    ``probe_x``; ``_probe_vec_jnp``, ``dla_tpu/validate/residual.py:162``):
    uniform in [-0.5, 0.5), fp32, the reference's bits. The uint32 hash runs in
    int64 with the low 32 bits masked after every multiply
    (``ops/lapack_like.py``)."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    h = _mix32(((i * _C1) & _MASK) ^ (seed & _MASK))
    return (h >> 8).to(torch.float32) * (1.0 / 16777216.0) - 0.5


def freivalds_device(
    l: torch.Tensor,
    *,
    seed: int = 51,
    bump: float | None = None,
    probes: int = 2,
    row_chunk: int = 4096,
) -> torch.Tensor:
    """On-device Freivalds residual for factors of seeded plgsy matrices too
    large to reconstruct: A is regenerated chunk by chunk from its seed inside
    the loop — O(N²) work, peak extra memory one (row_chunk, n) fp32 slab and
    its masked copy.

    Returns ``max_p ||(A − L·Lᵀ)x_p||_inf / (||A||_inf ||x_p||_inf)`` with the
    reference's probe vectors, so gates are comparable between the packages.
    ``l``'s strict upper triangle is ignored (masked per chunk); bf16 factors
    are read natively and widened one slab at a time (fp32 accumulation). The
    products are IEEE fp32 (TF32 is pinned off). Everything is built on
    ``l``'s device.
    """
    n = l.shape[-1]
    if n % row_chunk:
        raise ValueError(f"n={n} must be a multiple of row_chunk={row_chunk}")
    if bump is None:
        bump = float(n)
    dev = l.device
    x = torch.stack([_probe_vec(n, 0xC0FFEE ^ p, dev) for p in range(probes)], dim=1)
    xinf = x.abs().amax(dim=0)

    def ltri(r0: int) -> torch.Tensor:
        """tril-masked fp32 rows [r0, r0+row_chunk) of l."""
        return torch.tril(l[r0 : r0 + row_chunk], diagonal=r0).float()

    # pass 1: u = Lᵀ x (accumulated over row chunks)
    u = torch.zeros_like(x)
    for r0 in range(0, n, row_chunk):
        u += ltri(r0).mT @ x[r0 : r0 + row_chunk]

    # pass 2: per chunk, r_rows = A_rows·x − L_rows·u; track ||·||_inf and the
    # streaming ||A||_inf row sums
    num = torch.zeros_like(xinf)
    norm_a = torch.zeros((), dtype=torch.float32, device=dev)
    for r0 in range(0, n, row_chunk):
        a_rows = plgsy_tile(seed, r0, 0, row_chunk, n, bump=bump, dtype=torch.float32,
                            device=dev)
        y = a_rows @ x
        z = ltri(r0) @ u
        num = torch.maximum(num, (y - z).abs().amax(dim=0))
        norm_a = torch.maximum(norm_a, a_rows.abs().sum(dim=1).max())
    return (num / xinf).max() / norm_a


def residual_posv(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor, *,
                  assume_symmetric: bool = False) -> torch.Tensor:
    """Relative solve residual ``||B − A·X||_inf / (||A||_inf ||X||_inf)``,
    the normwise backward error of the solve path (POTRS / POSV;
    ``dla_tpu/validate/residual.py:120``). In float64 (complex128) on every
    device, as the JAX package under x64; ``a`` is symmetrized from its lower
    triangle unless ``assume_symmetric``. ``b`` and ``x`` may be vectors."""
    wide = torch.complex128 if a.is_complex() else torch.float64
    aw = a.to(wide)
    aa = aw if assume_symmetric else _symmetrize_lower(aw)
    xx = x.to(wide)
    xx = xx if xx.ndim == 2 else xx[:, None]
    bb = b.to(wide)
    r = (bb if bb.ndim == 2 else bb[:, None]) - aa @ xx
    return lange("I", r) / (lange("I", aa) * lange("I", xx))


class CholeskyInvariants(NamedTuple):
    """The reference worker's debug quantities as a checkable record."""

    nan_count: torch.Tensor
    inf_count: torch.Tensor
    diag_min: torch.Tensor  # min diag(L)  — must be > 0
    upper_maxabs: torch.Tensor  # max |strict upper(L)| — must be ~0
    fro_norm: torch.Tensor


def cholesky_invariants(l: torch.Tensor) -> CholeskyInvariants:
    upper = (torch.abs(torch.triu(l, 1)).max() if l.shape[-1] > 1
             else torch.zeros((), dtype=l.dtype, device=l.device))
    return CholeskyInvariants(
        nan_count=torch.isnan(l).sum(),
        inf_count=torch.isinf(l).sum(),
        diag_min=torch.diagonal(l).min(),
        upper_maxabs=upper,
        fro_norm=lange("F", l),
    )
