"""Residual gate and numerical invariants — counterpart of
``dla_tpu/validate/residual.py``.

The reference's numerical contract (``v6_test.c:70-87``): a driver checks
``||A − L·Lᵀ||_inf / ||A||_inf < 1e-10`` and prints PASS/FAIL. As in the
JAX package, A is symmetrized from its lower triangle before both the
subtraction and the denominator norm, so the gate is meetable.

The residual is computed in float64 (complex128) on every device: the H100
has native fp64, and the JAX package's tests run under x64. The on-device
Freivalds gate (``freivalds_device``) is a later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dla_tpu_torch.ops import lange

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
