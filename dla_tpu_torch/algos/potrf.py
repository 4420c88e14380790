"""Blocked right-looking Cholesky (POTRF) in torch — counterpart of
``dla_tpu/algos/potrf.py``.

All four single-device formulations of the reference are here, each with
its reference twin's formulation, so the numbers stay comparable with the
JAX package:

- :func:`potrf_blocked`, the default of :func:`potrf`: one nb-wide panel
  step at a time on an (n, n) copy, the trailing update by column panels
  (``trailing="xla"``) or through kernel #1 over lower tile pairs
  (``"pallas"``); the panel by a diagonal factor plus a triangular solve
  (``panel="xla"``) or by kernel #4, :func:`panel_factor`, in one call
  (``"pallas"``);
- :func:`potrf_masked`: every step solves the full-height panel and updates
  the full matrix under a mask (≈3× the flops, as the reference's
  compile-once loop does by construction);
- :func:`potrf_shrink`: the trailing square shrinks step by step and the
  factor is assembled from column strips; the panel by a triangular solve,
  an inverse-GEMM (``"invgemm"``), a blocked TRSM (``"blocktrsm"``) or
  kernel #4; the trailing update by one GEMM on the symmetric square or by
  kernel #1 on its lower tiles. Its ``blocktrsm``/``pallas`` route is the
  ``highest`` tier of the reference's bench;
- :func:`potrf_inplace`: a single buffer, mutated. Each panel step factors
  the diagonal block by :func:`_chol_twolevel` (ib-wide inner panels) or
  one Cholesky call, solves the panel by :func:`_blocktrsm_panel` or by
  kernel #3, :func:`panel_apply`, and updates the trailing matrix in place
  through kernel #1.

``blocked``, ``masked`` and ``shrink`` leave their input untouched.
"""

from __future__ import annotations

from typing import Literal

import torch

from dla_tpu_torch.kernels.panel import panel_apply, panel_factor
from dla_tpu_torch.kernels.tiles import trailing_update_lower
from dla_tpu_torch.ops import gemm, potrf_unblocked, trsm
from dla_tpu_torch.utils import precision as _precision

DiagFactor = Literal["lax", "unblocked", "twolevel"]


def _auto_tb(nb: int) -> int:
    """Largest trailing-update tile tb ∈ {1024, 512, 256, 128} dividing nb
    (or divided by it): the reference's choice (``potrf.py:50-64``), kept
    for parity. Its table was tuned on the TPU and has not been retuned for
    the H100."""
    for cand in (1024, 512, 256, 128):
        if nb % cand == 0 or cand % nb == 0:
            return min(cand, nb)
    return min(nb, 128)


def _cholesky(d: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor reading only the lower triangle of ``d``. A
    non-SPD block gives an all-NaN factor, as ``lax.linalg.cholesky`` does,
    decided on the device (no host sync, no exception)."""
    l, info = torch.linalg.cholesky_ex(d, check_errors=False)
    return torch.where(info != 0, torch.full_like(l, float("nan")), l)


def _chol_tile(d: torch.Tensor, diag_factor: DiagFactor, ib: int = 512) -> torch.Tensor:
    if diag_factor == "unblocked":
        return potrf_unblocked(d)
    if diag_factor == "twolevel":
        return _chol_twolevel(d, ib=ib)
    if diag_factor == "lax":
        return _cholesky(d)
    raise ValueError(f"unknown diag_factor {diag_factor!r}")


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


def potrf_blocked(
    a: torch.Tensor,
    *,
    nb: int = 256,
    update_cols: int | None = None,
    diag_factor: DiagFactor = "lax",
    panel: Literal["xla", "pallas"] = "xla",
    trailing: Literal["xla", "pallas"] = "xla",
    precision: str | None = None,
) -> torch.Tensor:
    """Right-looking blocked Cholesky on an (n, n) copy of tril(a), one
    nb-wide panel step at a time; returns L (strict upper = 0), ``a``
    untouched. Only the lower triangle of ``a`` is read.

    ``update_cols`` is the width of the column panels of the ``"xla"``
    trailing update (default ``max(nb, n // 8)`` rounded to a multiple of
    nb). ``panel="pallas"`` factors each column panel with kernel #4
    (:func:`panel_factor`); ``trailing="pallas"`` updates the trailing matrix
    with kernel #1 over its lower nb-tile pairs. Both need n % nb == 0 and a
    real dtype; the ``"xla"`` routes take any n and complex (Hermitian)
    input.
    """
    n = a.shape[-1]
    if (panel == "pallas" or trailing == "pallas") and n % nb:
        raise ValueError(f"pallas paths require n % nb == 0, got {n} % {nb}")
    if update_cols is None:
        update_cols = max(nb, (n // 8 // nb) * nb or nb)
    cj = a.is_complex()
    with _precision.override(precision):
        out = torch.tril(a).contiguous()
        for off in range(0, n, nb):
            w = min(nb, n - off)
            t0 = off + w
            if panel == "pallas":
                newp = panel_factor(out[off:, off : off + w])
                out[off:, off : off + w] = newp
                lp = newp[w:]
            else:
                lkk = torch.tril(_chol_tile(out[off:t0, off:t0], diag_factor))
                out[off:t0, off:t0] = lkk
                if t0 >= n:
                    break
                lp = trsm(1.0, lkk, out[t0:, off:t0], side="R", uplo="L", transa=True,
                          conja=cj)
                out[t0:, off:t0] = lp
            if t0 >= n:
                break
            if trailing == "pallas":
                # in place on the view; a CUDA solve returns lp column-major
                trailing_update_lower(out[t0:, t0:], lp.contiguous(), tb=nb)
            else:  # the lower trapezoid, by column panels
                for c0 in range(t0, n, update_cols):
                    cw = min(update_cols, n - c0)
                    out[c0:, c0 : c0 + cw] = gemm(
                        -1.0, lp[c0 - t0 :], lp[c0 - t0 : c0 - t0 + cw], 1.0,
                        out[c0:, c0 : c0 + cw], transb=True, conjb=cj,
                    )
        return torch.tril(out)


def potrf_masked(a: torch.Tensor, *, nb: int = 256, diag_factor: DiagFactor = "lax") -> torch.Tensor:
    """Right-looking blocked Cholesky as the reference's single loop over
    panels: every step solves the full-height panel and applies a
    full-matrix masked trailing update (≈3× the flops of
    :func:`potrf_blocked`, as in the reference). Needs n % nb == 0
    (:func:`potrf` pads); ``a`` is untouched."""
    n = a.shape[-1]
    if n % nb:
        raise ValueError(f"potrf_masked requires n % nb == 0, got {n} % {nb}")
    cj = a.is_complex()
    rows = torch.arange(n, device=a.device)[:, None]
    out = torch.tril(a)
    for off in range(0, n, nb):
        panel = out[:, off : off + nb]
        lkk = torch.tril(_chol_tile(panel[off : off + nb], diag_factor))
        sol = trsm(1.0, lkk, panel, side="R", uplo="L", transa=True, conja=cj)
        below = rows >= off + nb
        newpanel = torch.where(below, sol, 0)
        newpanel[off : off + nb] = lkk
        out[:, off : off + nb] = newpanel
        lp = torch.where(below, newpanel, 0)
        out = gemm(-1.0, lp, lp, 1.0, out, transb=True, conjb=cj)
    return torch.tril(out)


def potrf_shrink(
    a: torch.Tensor,
    *,
    nb: int = 512,
    update_cols: int | None = None,
    diag_factor: DiagFactor = "lax",
    panel: Literal["xla", "pallas", "invgemm", "blocktrsm"] = "xla",
    trailing: Literal["xla", "pallas"] = "xla",
    tb: int | None = None,
    kb: int | None = None,
    trailing_alias: bool = False,
    precision: str | None = None,
    ib: int = 512,
) -> torch.Tensor:
    """Right-looking Cholesky on a *shrinking* trailing matrix, the factor
    assembled from column strips in a zeroed (n, n) output; ``a`` is
    untouched and only its lower triangle is read.

    ``panel``: a triangular solve (``"xla"``), TRSM-as-GEMM against the
    inverted diagonal block (``"invgemm"``), the blocked TRSM with ib×ib
    inverses (``"blocktrsm"``), or kernel #4 (``"pallas"``).
    ``trailing="xla"``: one GEMM on the full trailing square, kept
    symmetric (Hermitian for complex input). ``trailing="pallas"``: kernel
    #1 on the lower tb-tile pairs only (tb default :func:`_auto_tb`, kb
    default min(nb, 256)); ``trailing_alias=True`` updates one working
    copy of ``a`` in place, ``False`` gives each step a fresh trailing
    square, as the reference does. The kernel routes need n % nb == 0.
    ``update_cols`` is accepted for interface parity and not used.
    """
    n = a.shape[-1]
    del update_cols
    if (panel == "pallas" or trailing == "pallas") and n % nb:
        raise ValueError(f"pallas paths require n % nb == 0, got {n} % {nb}")
    cj = a.is_complex()
    with _precision.override(precision):
        if trailing != "pallas":
            t = torch.tril(a)
            t = t + torch.tril(t, -1).conj().mT
        elif trailing_alias:
            # the kernel updates t in place: never the caller's a
            t = a.clone(memory_format=torch.contiguous_format)
        else:
            # the kernel never reads above the diagonal and writes a copy
            t = a.contiguous()
        out = torch.zeros((n, n), dtype=a.dtype, device=a.device)
        for off in range(0, n, nb):
            m = n - off
            w = min(nb, m)
            lp = None
            if panel == "pallas":
                strip = panel_factor(t[:, :w])
                lp = strip[w:]
            else:
                lkk = torch.tril(_chol_tile(t[:w, :w], diag_factor, ib=ib))
                strip = lkk
                if m > w:
                    if panel == "invgemm":
                        eye = torch.eye(w, dtype=a.dtype, device=a.device)
                        linv = trsm(1.0, lkk, eye, side="L", transa=False)
                        lp = gemm(1.0, t[w:, :w], linv, 0.0,
                                  torch.zeros((m - w, w), dtype=a.dtype, device=a.device),
                                  transb=True, conjb=cj)
                    elif panel == "blocktrsm":
                        lp = _blocktrsm_panel(lkk, t[w:, :w], ib=ib)
                    else:
                        lp = trsm(1.0, lkk, t[w:, :w], side="R", uplo="L", transa=True,
                                  conja=cj)
                    strip = torch.cat([lkk, lp], dim=0)
            out[off:, off : off + w] = strip
            if m > w:
                if trailing == "pallas":
                    t = trailing_update_lower(
                        t[w:, w:], lp.contiguous(), tb=tb or _auto_tb(nb),
                        kb=kb if kb is not None else min(nb, 256), alias=trailing_alias,
                    )
                else:
                    t = gemm(-1.0, lp, lp, 1.0, t[w:, w:], transb=True, conjb=cj)
        return out


def potrf_inplace(
    a: torch.Tensor,
    *,
    nb: int = 8192,
    tb: int = 1024,
    kb: int = 256,
    diag_factor: DiagFactor = "twolevel",
    precision: str | None = None,
    ib: int = 512,
    panel: Literal["auto", "blocktrsm", "pallas"] = "auto",
    panel_ib: int = 256,
) -> torch.Tensor:
    """Single-buffer right-looking Cholesky. **Mutates ``a``** and returns it:
    each panel lands in place and the trailing update runs in place on the
    full buffer, so peak memory is one (n, n) buffer plus one column panel
    (the reference donates its input to the same effect).

    Only ``tril(result)`` is meaningful: the strict upper triangle outside
    the diagonal blocks is passed through from the input, the diagonal
    blocks' upper triangles are zero.

    ``panel``: ``"auto"``/``"blocktrsm"`` solves each panel by
    :func:`_blocktrsm_panel` (ib-wide inverses and GEMMs); ``"pallas"`` by
    kernel #3, :func:`panel_apply` (panel_ib-wide inverses), which needs fp32
    compute, nb % panel_ib == 0 and nb ≤ 2048.

    For ``bfloat16`` input the per-panel work (diagonal factor and panel
    solve) is upcast to fp32; the trailing update reads and writes bf16 with
    fp32 accumulation.
    """
    n = a.shape[-1]
    if n % nb or nb % tb:
        raise ValueError(f"need n % nb == 0 and nb % tb == 0, got {n}/{nb}/{tb}")
    panel_ib = min(panel_ib, nb)
    ctype = torch.float32 if a.dtype == torch.bfloat16 else a.dtype
    if panel == "pallas" and not (ctype == torch.float32 and nb % panel_ib == 0
                                  and nb <= 2048):
        raise ValueError(
            "panel='pallas' needs real fp32 compute, nb % panel_ib == 0 "
            f"and nb <= 2048; got dtype={a.dtype}, nb={nb}, panel_ib={panel_ib}"
        )
    if panel not in ("auto", "blocktrsm", "pallas"):
        raise ValueError(f"unknown panel {panel!r}")
    with _precision.override(precision):
        out = a
        for off in range(0, n, nb):
            w = nb
            d = out[off : off + w, off : off + w].to(ctype)
            lkk = torch.tril(_chol_tile(d, diag_factor, ib=ib))
            out[off : off + w, off : off + w] = lkk.to(out.dtype)
            if off + w >= n:
                break
            pb = out[off + w :, off : off + w].to(ctype)
            if panel == "pallas":
                # a CUDA Cholesky returns lkk column-major; the kernel takes row-major
                lp = panel_apply(lkk.contiguous(), pb, ib=panel_ib, tb=min(1024, nb))
            else:
                lp = _blocktrsm_panel(lkk, pb, ib=ib)
            lp = lp.to(out.dtype)
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
    """Factor an SPD (HPD) matrix, A = L·Lᵀ (L·Lᴴ), returning the ``uplo``
    triangle of the factor; ``a`` is not modified. Mirrors
    ``CHAMELEON_dpotrf_Tile(uplo, descA)`` (``v6_test.c:57``). ``kw`` goes to
    the mode's function (:func:`potrf_blocked`, :func:`potrf_masked`,
    :func:`potrf_shrink`, :func:`potrf_inplace`).

    ``uplo='U'``: the meaningful data of ``a`` is its upper triangle
    (A = UᴴU), factored as the lower factorization of the reflected matrix.
    ``uplo='B'``: L in the lower and Lᴴ in the upper triangle.

    ``mode="masked"`` pads n to a multiple of nb with an identity block.
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
    if mode == "blocked":
        return potrf_blocked(a, nb=nb, **kw)
    if mode == "shrink":
        return potrf_shrink(a, nb=nb, **kw)
    if mode == "inplace":
        # potrf_inplace mutates its input: work on a row-major copy. The
        # trailing tile is 1024 where it divides nb, else nb itself; tril
        # restores the zeros-above contract.
        tb = kw.pop("tb", None) or (1024 if nb % 1024 == 0 else nb)
        ac = a.clone(memory_format=torch.contiguous_format)
        return torch.tril(potrf_inplace(ac, nb=nb, tb=tb, **kw))
    if mode == "masked":
        n = a.shape[-1]
        if n % nb:
            pad = nb - n % nb
            ap = torch.zeros((n + pad, n + pad), dtype=a.dtype, device=a.device)
            ap[:n, :n] = torch.tril(a)
            ap[n:, n:].diagonal().fill_(1)
            return potrf_masked(ap, nb=nb, **kw)[:n, :n]
        return potrf_masked(a, nb=nb, **kw)
    raise ValueError(f"unknown mode {mode!r}")
