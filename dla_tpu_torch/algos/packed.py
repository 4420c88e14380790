"""Packed (triangle-only) storage: Cholesky on about half the memory —
counterpart of ``dla_tpu/algos/packed.py``.

Layout, the reference's: the **column-slab packed lower triangle** with slab
width ``tb`` (``n % tb == 0``). Block column ``j`` is stored as the dense
``((nt-j)·tb, tb)`` slab ``A[j·tb:, j·tb:(j+1)·tb]``, row-major, and the slabs
are stacked into one 2-D ``(n·(n+tb)/(2·tb), tb)`` buffer — n(n+tb)/2
elements instead of n². The buffer has the same layout in both packages, so
a JAX packed array crosses through ``utils.interop`` unchanged.

Every algorithm below touches contiguous row ranges of that buffer.
:func:`col_slab` returns a view, and :func:`potrf_packed` factors the buffer
**in place** and returns it (the reference donates it to the same effect).

Ported: the factorization path and its matrix-free gate,
:func:`plgsy_packed` → :func:`potrf_packed` → :func:`freivalds_packed`
(through :func:`trmm_packed` and :func:`spd_matvec_streamed`); the packed
substitution :func:`potrs_packed` with its :func:`_diag_invs`, which the
packed df64 solve builds on; and the packed serving path, the inverse in
packed space (:func:`trtri_packed` → :func:`lauum_packed`, together
:func:`potri_packed`), its apply :func:`solve_inverse_packed`, and the
streamed solve residual :func:`residual_posv_streamed`. Like
:func:`potrf_packed`, the three inverse steps overwrite their input buffer
column by column and return it (the reference donates the buffer to the same
effect); the column order keeps that safe. Complex dtypes are not ported
(``ROADMAP.md`` Queue A item 5).
"""

from __future__ import annotations

from typing import Literal

import torch

from dla_tpu_torch.algos.potrf import DiagFactor, _blocktrsm_panel, _chol_tile
from dla_tpu_torch.algos.solve import _solve_lower_blocked
from dla_tpu_torch.kernels.tiles import trailing_update_packed
from dla_tpu_torch.ops import gemm, plgsy_tile, trsm
from dla_tpu_torch.ops.lapack_like import _SLAB_ELEMS
from dla_tpu_torch.utils import precision as _precision


def packed_len(n: int, tb: int) -> int:
    """Element count of the packed triangle: n·(n+tb)/2."""
    _check(n, tb)
    nt = n // tb
    return tb * tb * nt * (nt + 1) // 2


def packed_rows(n: int, tb: int) -> int:
    """Leading dim of the packed (rows, tb) buffer: n·(n+tb)/(2·tb)."""
    return packed_len(n, tb) // tb


def _check(n: int, tb: int) -> None:
    if n % tb:
        raise ValueError(f"n={n} must be a multiple of tb={tb}")


def _row_offset(j: int, nt: int, tb: int) -> int:
    """Row offset of block column j's slab in the (rows, tb) buffer."""
    return tb * (j * nt - j * (j - 1) // 2)


def col_slab(packed: torch.Tensor, j: int, n: int, tb: int) -> torch.Tensor:
    """Block column j as its ((nt-j)·tb, tb) row range — a **view** of the
    buffer: writing to it writes to ``packed``."""
    nt = n // tb
    r0 = _row_offset(j, nt, tb)
    return packed[r0 : r0 + (nt - j) * tb]


def _set_col(packed: torch.Tensor, j: int, slab: torch.Tensor, n: int, tb: int) -> torch.Tensor:
    """Write block column j in place (cast to the buffer's dtype)."""
    col_slab(packed, j, n, tb).copy_(slab)
    return packed


def pack_tri(a: torch.Tensor, tb: int) -> torch.Tensor:
    """Dense (n, n) → packed lower triangle, a (n·(n+tb)/(2·tb), tb) buffer
    (reads only the slabs on and below the diagonal; each diagonal block is
    copied whole, its strict upper included, as in the reference)."""
    n = a.shape[-1]
    _check(n, tb)
    return torch.cat([a[j * tb :, j * tb : (j + 1) * tb] for j in range(n // tb)], dim=0)


def unpack_tri(packed: torch.Tensor, n: int, tb: int) -> torch.Tensor:
    """Packed → dense lower-triangular (strict upper zeroed: the diagonal
    blocks carry whatever the source had above the diagonal)."""
    _check(n, tb)
    out = torch.zeros((n, n), dtype=packed.dtype, device=packed.device)
    for j in range(n // tb):
        out[j * tb :, j * tb : (j + 1) * tb] = col_slab(packed, j, n, tb)
    return torch.tril(out)


def _ctype(dtype: torch.dtype) -> torch.dtype:
    """Compute dtype: bf16 storage computes in fp32."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _diag_invs(packed: torch.Tensor, n: int, tb: int) -> list[torch.Tensor]:
    """inv(L[k,k]) for every diagonal block (lower-triangular inverses, read
    from the blocks' lower triangles). Blocks wider than 1024 go through the
    block-inverse solve, as in the reference; the others through one
    triangular solve, which is IEEE fp32 whatever the precision tier (the
    reference pins it: a one-bf16-pass inverse caps every refinement built on
    it)."""
    ct = _ctype(packed.dtype)
    eye = torch.eye(tb, dtype=ct, device=packed.device)
    out = []
    for k in range(n // tb):
        dk = col_slab(packed, k, n, tb)[:tb].to(ct)
        if tb > 1024:
            out.append(_solve_lower_blocked(dk, eye, trans=False, ib=512))
        else:
            out.append(trsm(1.0, dk, eye, side="L", uplo="L", transa=False))
    return out


def _real_only(name: str, t: torch.Tensor) -> None:
    if t.is_complex():
        raise NotImplementedError(
            f"{name} on complex dtypes is not ported yet; see ROADMAP.md Queue A5")


def trtri_packed(lp: torch.Tensor, n: int, tb: int) -> torch.Tensor:
    """K = L⁻¹ in packed space, **in place**: ``lp`` is overwritten with K and
    returned. Column j of K replaces column j of L only after it is whole,
    and later columns read only columns > j, so the order is safe.
    Column-oriented right-looking substitution over contiguous column-slab
    slices, with the diagonal blocks' inverses from :func:`_diag_invs`."""
    _check(n, tb)
    _real_only("trtri_packed", lp)
    nt = n // tb
    ct = _ctype(lp.dtype)
    dinv = _diag_invs(lp, n, tb)
    for j in range(nt):
        x = torch.zeros(((nt - j) * tb, tb), dtype=ct, device=lp.device)
        x[:tb] = dinv[j]
        if j + 1 < nt:
            strict = col_slab(lp, j, n, tb)[tb:].to(ct)
            x[tb:] = -gemm(1.0, strict, dinv[j], 0.0, x[tb:])
        for k in range(j + 1, nt):  # the rest of the substitution, one column step each
            i0 = (k - j) * tb
            xk = gemm(1.0, dinv[k], x[i0 : i0 + tb], 0.0, x[i0 : i0 + tb])
            x[i0 : i0 + tb] = xk
            if k + 1 < nt:
                strict = col_slab(lp, k, n, tb)[tb:].to(ct)
                x[i0 + tb :] = gemm(-1.0, strict, xk, 1.0, x[i0 + tb :])
        _set_col(lp, j, x, n, tb)
    return lp


def lauum_packed(kp: torch.Tensor, n: int, tb: int) -> torch.Tensor:
    """Lower triangle of KᵀK from packed K (the lauum-of-inverse step of
    POTRI), **in place**: ``kp`` is overwritten and returned. One
    (tb, (nt−i)·tb)·((nt−i)·tb, tb) product per output tile; column j is
    overwritten only once its slab is done, from columns ≥ j of K."""
    _check(n, tb)
    _real_only("lauum_packed", kp)
    nt = n // tb
    ct = _ctype(kp.dtype)
    for j in range(nt):
        colj = col_slab(kp, j, n, tb).to(ct)
        z = torch.zeros((tb, tb), dtype=ct, device=kp.device)
        blocks = [gemm(1.0, col_slab(kp, i, n, tb).to(ct), colj[(i - j) * tb :], 0.0, z,
                       transa=True) for i in range(j, nt)]
        _set_col(kp, j, torch.cat(blocks), n, tb)
    return kp


def potri_packed(lp: torch.Tensor, n: int, tb: int) -> torch.Tensor:
    """Packed factor → packed symmetric inverse, A⁻¹ = L⁻ᵀ·L⁻¹ computed
    entirely in packed space (about 2·n³/3 flops), **in place**: ``lp`` is
    overwritten and returned; beside it one column slab at a time."""
    return lauum_packed(trtri_packed(lp, n, tb), n, tb)


def solve_inverse_packed(sp: torch.Tensor, b: torch.Tensor, n: int, tb: int) -> torch.Tensor:
    """The serving apply X = A⁻¹·B from the *packed symmetric* inverse: it
    streams the n(n+tb)/2 elements of A⁻¹ once per query, half the dense
    :func:`~dla_tpu_torch.algos.potri.solve_inverse` product's bytes. Per
    block column j: X[j·tb:] += S[:, j]·B_j (the lower triangle, diagonal
    included) and X_j += S[j+1:, j]ᵀ·B[(j+1)·tb:] (the strict upper, by
    symmetry). ``b`` is (n,) or (n, nrhs); returns a new tensor in the
    compute dtype."""
    _check(n, tb)
    _real_only("solve_inverse_packed", sp)
    nt = n // tb
    vec = b.ndim == 1
    ct = _ctype(sp.dtype)
    bb = (b[:, None] if vec else b).to(ct)
    x = torch.zeros((n, bb.shape[-1]), dtype=ct, device=sp.device)
    for j in range(nt):
        colj = col_slab(sp, j, n, tb).to(ct)
        x[j * tb :] = gemm(1.0, colj, bb[j * tb : (j + 1) * tb], 1.0, x[j * tb :])
        if j + 1 < nt:
            x[j * tb : (j + 1) * tb] = gemm(1.0, colj[tb:], bb[(j + 1) * tb :], 1.0,
                                            x[j * tb : (j + 1) * tb], transa=True)
    return x[:, 0] if vec else x


def potrs_packed(lp: torch.Tensor, b: torch.Tensor, n: int, tb: int) -> torch.Tensor:
    """Solve A·X = B from the packed factor (packed ``dpotrs``): forward then
    back substitution over column slabs, diagonal blocks applied via their
    precomputed triangular inverses. Returns a new tensor in the factor's
    compute dtype; ``b`` is left alone."""
    _check(n, tb)
    nt = n // tb
    vec = b.ndim == 1
    cj = lp.is_complex()
    ct = _ctype(lp.dtype)
    x = (b[:, None] if vec else b).to(ct, copy=True)
    dinv = _diag_invs(lp, n, tb)
    for k in range(nt):  # forward: L·Y = B
        blk = slice(k * tb, (k + 1) * tb)
        x[blk] = gemm(1.0, dinv[k], x[blk], 0.0, x[blk])
        if k + 1 < nt:
            strict = col_slab(lp, k, n, tb)[tb:].to(ct)
            x[(k + 1) * tb :] = gemm(-1.0, strict, x[blk], 1.0, x[(k + 1) * tb :])
    for k in reversed(range(nt)):  # back: Lᵀ·X = Y
        blk = slice(k * tb, (k + 1) * tb)
        rhs = x[blk]
        if k + 1 < nt:
            strict = col_slab(lp, k, n, tb)[tb:].to(ct)
            rhs = gemm(-1.0, strict, x[(k + 1) * tb :], 1.0, rhs, transa=True, conja=cj)
        x[blk] = gemm(1.0, dinv[k], rhs, 0.0, rhs, transa=True, conja=cj)
    return x[:, 0] if vec else x


def plgsy_packed(
    n: int,
    tb: int,
    *,
    bump: float | None = None,
    seed: int = 51,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> torch.Tensor:
    """Packed lower triangle of the seeded SPD test matrix, generated slab by
    slab (in row chunks) from the tile-local generator into one preallocated
    buffer on ``device`` (the card unless the caller names another) — no
    dense (n, n) square is ever built. Bit-identical
    to the reference's ``plgsy_packed`` and to ``tril(plgsy(n))``."""
    _check(n, tb)
    if bump is None:
        bump = float(n)  # same SPD default as plgsy (v6_test.c:46)
    nt = n // tb
    out = torch.empty((packed_rows(n, tb), tb), dtype=dtype, device=device)
    chunk = max(1, _SLAB_ELEMS // tb)
    for j in range(nt):
        r0 = _row_offset(j, nt, tb)
        for i in range(0, (nt - j) * tb, chunk):
            rows = min(chunk, (nt - j) * tb - i)
            out[r0 + i : r0 + i + rows] = plgsy_tile(
                seed, j * tb + i, j * tb, rows, tb, bump=bump, dtype=dtype, device=device
            )
    return out


def potrf_packed(
    ap: torch.Tensor,
    n: int,
    tb: int,
    *,
    diag_factor: DiagFactor = "twolevel",
    ib: int = 512,
    precision: str | None = None,
    trailing: Literal["xla", "pallas"] = "xla",
    ktb: int = 1024,
    kb: int | None = None,
) -> torch.Tensor:
    """Right-looking Cholesky **in packed space**. **Mutates ``ap``** and
    returns it: peak device memory is one packed triangle (n(n+tb)/2
    elements) plus one column slab. Per step: factor the diagonal block and
    blocked-TRSM the panel (both shared with ``potrf_inplace``), then update
    the trailing triangle.

    ``trailing="pallas"`` (the reference's name, kept so that driver flags
    line up) runs the trailing update through the hand-written kernel
    (:func:`dla_tpu_torch.kernels.tiles.trailing_update_packed`, kernel tile
    ``min(ktb, tb)``, ``kb`` checked against tb). It updates the lower
    ktb-tile pairs only, so the ktb-tiles above the diagonal inside each
    diagonal slab block stay stale: only :func:`unpack_tri`'s tril is
    meaningful. ``trailing="xla"`` is the reference's per-slab GEMM loop.

    bf16 storage computes the panel in fp32; the trailing update reads and
    writes bf16 with fp32 accumulation. Real dtypes only.
    """
    _check(n, tb)
    if ap.is_complex():
        raise NotImplementedError(
            "potrf_packed on complex dtypes is not ported yet; see ROADMAP.md Queue A"
        )
    if trailing not in ("xla", "pallas"):
        raise ValueError(f"trailing must be 'xla' or 'pallas', got {trailing!r}")
    nt = n // tb
    ct = _ctype(ap.dtype)
    with _precision.override(precision):
        for k in range(nt):
            colk = col_slab(ap, k, n, tb)
            lkk = torch.tril(_chol_tile(colk[:tb].to(ct), diag_factor, ib=ib))
            colk[:tb].copy_(lkk)
            if k + 1 == nt:
                break
            lik = _blocktrsm_panel(lkk, colk[tb:].to(ct), ib=ib)
            colk[tb:].copy_(lik)
            if trailing == "pallas":
                trailing_update_packed(ap, lik.to(ap.dtype), n=n, w=tb, k=k,
                                       tb=min(ktb, tb), kb=kb)
                continue
            for j in range(k + 1, nt):
                i0 = (j - k - 1) * tb  # lik rows j·tb.. of block column k
                upd = gemm(-1.0, lik[i0:], lik[i0 : i0 + tb], 1.0,
                           col_slab(ap, j, n, tb).to(ct), transb=True)
                _set_col(ap, j, upd, n, tb)
    return ap


def trmm_packed(
    lp: torch.Tensor, b: torch.Tensor, n: int, tb: int, *, trans: bool = False
) -> torch.Tensor:
    """Y = L·B (or Lᵀ·B) from the packed factor — one GEMM per block column
    (the packed ``dtrmm`` of the matrix-free gate)."""
    _check(n, tb)
    vec = b.ndim == 1
    bb = b[:, None] if vec else b
    ct = _ctype(lp.dtype)
    bb = bb.to(ct)
    y = torch.zeros((n, bb.shape[-1]), dtype=ct, device=lp.device)
    for j in range(n // tb):
        colj = col_slab(lp, j, n, tb).to(ct)
        if not trans:
            y[j * tb :] = gemm(1.0, colj, bb[j * tb : (j + 1) * tb], 1.0, y[j * tb :])
        else:
            y[j * tb : (j + 1) * tb] = gemm(1.0, colj, bb[j * tb :], 0.0,
                                           y[j * tb : (j + 1) * tb], transa=True)
    return y[:, 0] if vec else y


def _strips(n: int, cb: int, seed: int, bump: float, dtype: torch.dtype, device):
    """The (n, cb) column strips of the seeded SPD matrix, one at a time."""
    for j0 in range(0, n, cb):
        yield j0, plgsy_tile(seed, 0, j0, n, cb, bump=bump, dtype=dtype, device=device)


def spd_matvec_streamed(
    x: torch.Tensor, n: int, *, seed: int = 51, bump: float | None = None, cb: int = 1024,
) -> torch.Tensor:
    """A·X for the seeded SPD generator matrix **without materializing A**:
    (n, cb) column strips are generated on x's device in x's compute dtype
    and accumulated in IEEE arithmetic (the reference pins
    ``precision="highest"``) — O(n·cb) memory beside x. The reference's
    ``dtype`` argument, which it does not read, is left out."""
    cb = min(cb, n)
    if n % cb:
        raise ValueError(f"n={n} must be a multiple of cb={cb}")
    if bump is None:
        bump = float(n)
    vec = x.ndim == 1
    xx = x[:, None] if vec else x
    xx = xx.to(_ctype(xx.dtype))
    acc = torch.zeros((n, xx.shape[-1]), dtype=xx.dtype, device=xx.device)
    for j0, strip in _strips(n, cb, seed, bump, xx.dtype, xx.device):
        acc += strip @ xx[j0 : j0 + cb]
    return acc[:, 0] if vec else acc


def freivalds_packed(
    lp: torch.Tensor, n: int, tb: int, *, seed: int = 51,
    bump: float | None = None, nprobe: int = 2, key: int = 0,
) -> torch.Tensor:
    """Matrix-free Freivalds gate for a packed factor of the seeded SPD
    matrix: ||A·x − L·(Lᵀ·x)||_inf / (||A||_inf · ||x||_inf), with A applied
    by :func:`spd_matvec_streamed` and its norm accumulated over the same
    streamed strips. The reference's contract and denominator.

    The probe x is ``nprobe`` standard-normal columns drawn from a
    ``torch.Generator`` seeded with ``key`` (on the CPU, then moved to the
    factor's device, so the probe does not depend on the device). It is
    *not* the reference's ``jax.random.normal(PRNGKey(key))``: torch cannot
    reproduce those bits. The gate is a statistic of the probe, so the two
    packages agree on it in magnitude, not in bits.
    """
    if bump is None:
        bump = float(n)
    ct = _ctype(lp.dtype)
    cb = 1024 if n % 1024 == 0 else tb
    g = torch.Generator().manual_seed(key)
    x = torch.randn((n, nprobe), generator=g, dtype=ct).to(lp.device)
    ax = spd_matvec_streamed(x, n, seed=seed, bump=bump, cb=cb)
    y = trmm_packed(lp, trmm_packed(lp, x, n, tb, trans=True), n, tb)
    na = torch.zeros((n,), dtype=ct, device=lp.device)
    for _, strip in _strips(n, cb, seed, bump, ct, lp.device):
        na += strip.abs().sum(dim=1)
    denom = na.max() * x.abs().max()
    return (ax - y).abs().max() / denom


def residual_posv_streamed(
    x: torch.Tensor, b: torch.Tensor, n: int, *, seed: int = 51,
    bump: float | None = None, cb: int = 1024,
) -> torch.Tensor:
    """``||B − A·X||_inf / (||A||_inf·||X||_inf)`` for the seeded SPD
    generator matrix, with A applied (:func:`spd_matvec_streamed`) and its
    row sums accumulated over (n, cb) strips generated on x's device: the
    solve path's check when A cannot sit beside the packed state (the
    contract of ``validate.residual_posv``), in x's compute dtype."""
    _real_only("residual_posv_streamed", x)
    if bump is None:
        bump = float(n)
    cb = min(cb, n)
    ct = _ctype(x.dtype)
    ax = spd_matvec_streamed(x, n, seed=seed, bump=bump, cb=cb)
    na = torch.zeros((n,), dtype=ct, device=x.device)
    for _, strip in _strips(n, cb, seed, bump, ct, x.device):
        na += strip.abs().sum(dim=1)
    denom = na.max() * x.abs().max()
    return (b.to(ct) - ax).abs().max() / denom
