"""Blocked right-looking Cholesky (POTRF) in torch — counterpart of
``dla_tpu/algos/potrf.py``.

This slice ports the single-buffer formulation :func:`potrf_inplace` and the
public :func:`potrf` entry for ``mode="inplace"``. Each nb-wide panel step
keeps the reference's formulation, so the numbers stay comparable with the
JAX package:

1. the diagonal block is factored by :func:`_chol_twolevel` (ib-wide inner
   panels: Cholesky at the leaves, inverse-GEMM solves, trailing GEMMs) or by
   one Cholesky call (``diag_factor="lax"``);
2. the panel is solved by :func:`_blocktrsm_panel`: the inverses of its
   ib×ib diagonal blocks plus GEMMs;
3. the trailing matrix gets C ← C − P·Pᵀ in place over its lower tile pairs,
   through the Hopper kernel (:func:`dla_tpu_torch.kernels.tiles.trailing_update_lower`).

The packed and df64 formulations live in ``algos/packed.py`` and
``algos/potrf_df64.py``; the blocked, masked and shrink formulations and the
Pallas panel option are later slices (``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Literal

import torch

from dla_tpu_torch.kernels.tiles import trailing_update_lower
from dla_tpu_torch.ops import gemm, trsm
from dla_tpu_torch.utils import precision as _precision

DiagFactor = Literal["lax", "twolevel"]

_LATER = "is not ported yet; see ROADMAP.md Queue A/B"


def _cholesky(d: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor reading only the lower triangle of ``d``. A
    non-SPD block gives an all-NaN factor, as ``lax.linalg.cholesky`` does,
    decided on the device (no host sync, no exception)."""
    l, info = torch.linalg.cholesky_ex(d, check_errors=False)
    return torch.where(info != 0, torch.full_like(l, float("nan")), l)


def _chol_tile(d: torch.Tensor, diag_factor: DiagFactor, ib: int = 512) -> torch.Tensor:
    if diag_factor == "twolevel":
        return _chol_twolevel(d, ib=ib)
    if diag_factor == "lax":
        return _cholesky(d)
    raise NotImplementedError(f"diag_factor={diag_factor!r} {_LATER}")


def _chol_twolevel(d: torch.Tensor, ib: int = 512) -> torch.Tensor:
    """Blocked right-looking factor of one diagonal block with ib-wide inner
    panels: Cholesky at the ib leaves, everything else inverse-GEMM and
    trailing GEMM."""
    n = d.shape[-1]
    if n <= ib:
        return _cholesky(d)
    cj = d.is_complex()
    out = torch.zeros_like(d)
    t = d
    eye = torch.eye(ib, dtype=d.dtype, device=d.device)
    for off in range(0, n, ib):
        w = min(ib, n - off)
        lkk = torch.tril(_cholesky(t[:w, :w]))
        if off + w < n:
            linv = trsm(1.0, lkk, eye[:w, :w], side="L", transa=False)
            lp = gemm(
                1.0, t[w:, :w], linv, 0.0,
                torch.zeros((n - off - w, w), dtype=d.dtype, device=d.device),
                transb=True, conjb=cj,
            )
            out[off:, off : off + w] = torch.cat([lkk, lp], dim=0)
            t = gemm(-1.0, lp, lp, 1.0, t[w:, w:], transb=True, conjb=cj)
        else:
            out[off : off + w, off : off + w] = lkk
    return out


def _blocktrsm_panel(lkk: torch.Tensor, b: torch.Tensor, *, ib: int = 512) -> torch.Tensor:
    """Blocked TRSM: X·Lᵀ = B with only the ib×ib diagonal blocks of L
    inverted — X[:, j] = (B[:, j] − X[:, <j]·L[j, <j]ᵀ)·inv(L_jj)ᵀ."""
    w = lkk.shape[0]
    cj = lkk.is_complex()
    ib = min(ib, w)
    eye = torch.eye(ib, dtype=lkk.dtype, device=lkk.device)
    x = torch.zeros_like(b)
    for off in range(0, w, ib):
        dinv = trsm(1.0, lkk[off : off + ib, off : off + ib], eye, side="L", transa=False)
        rhs = b[:, off : off + ib]
        if off:
            rhs = gemm(-1.0, x[:, :off], lkk[off : off + ib, :off], 1.0, rhs,
                       transb=True, conjb=cj)
        x[:, off : off + ib] = gemm(1.0, rhs, dinv, 0.0, torch.zeros_like(rhs),
                                   transb=True, conjb=cj)
    return x


def potrf_inplace(
    a: torch.Tensor,
    *,
    nb: int = 8192,
    tb: int = 1024,
    kb: int = 256,
    diag_factor: DiagFactor = "twolevel",
    precision: str | None = None,
    ib: int = 512,
    panel: Literal["auto", "blocktrsm"] = "auto",
) -> torch.Tensor:
    """Single-buffer right-looking Cholesky. **Mutates ``a``** and returns it:
    each panel lands in place and the trailing update runs in place on the
    full buffer, so peak memory is one (n, n) buffer plus one column panel
    (the reference donates its input to the same effect).

    Only ``tril(result)`` is meaningful: the strict upper triangle outside
    the diagonal blocks is passed through from the input, the diagonal
    blocks' upper triangles are zero.

    For ``bfloat16`` input the per-panel work (diagonal factor and blocked
    TRSM) is upcast to fp32; the trailing update reads and writes bf16 with
    fp32 accumulation.
    """
    n = a.shape[-1]
    if n % nb or nb % tb:
        raise ValueError(f"need n % nb == 0 and nb % tb == 0, got {n}/{nb}/{tb}")
    if panel not in ("auto", "blocktrsm"):
        raise NotImplementedError(f"panel={panel!r} {_LATER} (#3 panel_apply)")
    with _precision.override(precision):
        ctype = torch.float32 if a.dtype == torch.bfloat16 else a.dtype
        out = a
        for off in range(0, n, nb):
            w = nb
            d = out[off : off + w, off : off + w].to(ctype)
            lkk = torch.tril(_chol_tile(d, diag_factor, ib=ib))
            out[off : off + w, off : off + w] = lkk.to(out.dtype)
            if off + w >= n:
                break
            pb = out[off + w :, off : off + w].to(ctype)
            lp = _blocktrsm_panel(lkk, pb, ib=ib).to(out.dtype)
            out[off + w :, off : off + w] = lp
            out = trailing_update_lower(
                out, lp, tb=tb, kb=min(kb, nb), alias=True, origin=(off + w) // tb,
            )
        return out


def potrf(
    a: torch.Tensor,
    *,
    nb: int = 256,
    mode: Literal["blocked", "masked", "shrink", "inplace"] = "blocked",
    uplo: str = "L",
    **kw,
) -> torch.Tensor:
    """Factor an SPD matrix, A = L·Lᵀ, returning the ``uplo`` triangle of the
    factor; ``a`` is not modified. Mirrors ``CHAMELEON_dpotrf_Tile(uplo,
    descA)`` (``v6_test.c:57``).

    ``uplo='U'``: the meaningful data of ``a`` is its upper triangle
    (A = UᵀU), factored as the lower factorization of the reflected matrix.
    ``uplo='B'``: L in the lower and Lᵀ in the upper triangle.

    Only ``mode="inplace"`` is ported; the other modes raise
    ``NotImplementedError``.
    """
    u = uplo.upper()
    if u == "B":
        l = potrf(a, nb=nb, mode=mode, uplo="L", **kw)
        return l + torch.tril(l, -1).conj().mT
    if u == "U":
        al = torch.triu(a).conj().mT
        l = potrf(al, nb=nb, mode=mode, uplo="L", **kw)
        return l.conj().mT.contiguous()
    if u != "L":
        raise ValueError(f"uplo must be 'L', 'U', or 'B', got {uplo!r}")
    if mode == "inplace":
        # potrf_inplace mutates its input: work on a row-major copy. The
        # trailing tile is 1024 where it divides nb, else nb itself; tril
        # restores the zeros-above contract.
        tb = kw.pop("tb", None) or (1024 if nb % 1024 == 0 else nb)
        ac = a.clone(memory_format=torch.contiguous_format)
        return torch.tril(potrf_inplace(ac, nb=nb, tb=tb, **kw))
    if mode in ("blocked", "masked", "shrink"):
        raise NotImplementedError(f"potrf mode={mode!r} {_LATER}; use mode='inplace'")
    raise ValueError(f"unknown mode {mode!r}")
