"""Blocked Cholesky in emulated fp64 (df64), dense and packed, with its df64
solves and gates — counterpart of ``dla_tpu/algos/potrf_df64.py``.

A matrix is a pair ``(hi, lo)`` of fp32 planes (``ops/df64``: ~49 significant
bits), and each nb-wide panel step keeps the reference's formulation:

1. **diagonal factor** (:func:`_factor_diag_df64`): the block is
   re-symmetrized from its lower triangle, factored by an fp32 Cholesky, and
   refined: E = A_kk − L·Lᵀ in df64, dL = L·Φ(L⁻¹·E·L⁻ᵀ) solved in fp32, Φ the
   strict lower triangle plus half the diagonal; two steps reach the df64
   floor;
2. **panel solve** (:func:`_panel_solve_df64`): an fp32 TRSM and the same
   df64-residual refinement;
3. **trailing update** C ← C − X·Xᵀ from the panel's s exact bf16 slices:
   the strip loop over :func:`dla_tpu_torch.ops.df64.df64_matmul_nt`
   (``trailing="xla"``) or the Hopper kernel
   :func:`dla_tpu_torch.kernels.df64_tiles.trailing_update_df64`
   (``trailing="pallas"``), which does ~all the flops.

:func:`potrf_packed_df64` runs the same three steps on a pair of column-slab
packed triangles (``algos/packed.py`` layout, slab width nb): about 4·n² bytes
resident instead of the dense pair's 8·n², with the trailing update in
:func:`dla_tpu_torch.kernels.df64_tiles.trailing_update_packed_df64`.
:func:`potrs_df64` and :func:`potrs_packed_df64` solve L·Lᵀ·X = B in df64 by
fp32 substitution plus df64-residual refinement.

The residual gates measure ``||A − L·Lᵀ||_inf / ||A||_inf`` in df64 on the
tensors' device: :func:`residual_potrf_df64` holds the whole slice set of L,
:func:`residual_potrf_df64_blocked` only two row strips of it, and can stream A
from its seed. The streaming Freivalds gates measure ``max_p ||(A − L·Lᵀ)·x_p||
/ (||A||·||x_p||)`` with every matvec in df64, O(n²) work and strip-sized
transients: :func:`freivalds_potrf_df64` (dense pair, resident A),
:func:`freivalds_potrf_df64_gen` (A streamed from its seed) and
:func:`freivalds_packed_df64` (straight off the packed pair, no unpack, no
dense A). Their probes are numpy's (``default_rng(seed).standard_normal``), so
both packages draw the same ones. The reference splits all of these into
jitted strip programs for its remote compiler; here they are plain loops, and
the same quantities come out.
"""

from __future__ import annotations

import numpy as np
import torch

from dla_tpu_torch.algos.packed import _check as _check_packed
from dla_tpu_torch.algos.packed import col_slab, potrs_packed
from dla_tpu_torch.algos.potrf import _cholesky
from dla_tpu_torch.kernels.df64_tiles import trailing_update_df64, trailing_update_packed_df64
from dla_tpu_torch.ops.df64 import df64_matmul_nt, df_add, df_sub, slice_rows, two_sum
from dla_tpu_torch.ops.lapack_like import plgsy_tile

_F32 = torch.float32


def _phi(m):
    """Φ(M) = strict lower triangle + half the diagonal (the lower-triangular
    solution of Φ + Φᵀ = M for symmetric M)."""
    return torch.tril(m, -1) + 0.5 * torch.diag_embed(torch.diagonal(m))


def _factor_diag_df64(akk_h, akk_l, *, refine: int, gemm_kw) -> tuple:
    """df64 Cholesky of one nb×nb block: fp32 factor + `refine` steps of
    df64-residual correction (each O(eps32) → O(eps32²) → df64 floor).

    The block is re-symmetrized from its LOWER triangle first: the trailing
    kernel updates lower tiles only, so with tb < nb the block's upper tiles
    are stale, and the refinement residual E = A − L·Lᵀ reads the full block."""
    low_h = torch.tril(akk_h)
    low_l = torch.tril(akk_l)
    d_h = torch.diag_embed(torch.diagonal(akk_h))
    d_l = torch.diag_embed(torch.diagonal(akk_l))
    akk_h, akk_l = df_add(low_h, low_l, low_h.mT - d_h, low_l.mT - d_l)
    l0 = torch.tril(_cholesky(akk_h))  # all-NaN when not SPD, as lax.linalg.cholesky
    lh, ll = l0, torch.zeros_like(l0)
    for _ in range(refine):
        ph, pl = df64_matmul_nt(lh, ll, lh, ll, **gemm_kw)
        eh, el = df_sub(akk_h, akk_l, ph, pl)
        # M = L⁻¹ E L⁻ᵀ in fp32 (E ~ eps·|A|: the fp32 relative error of the
        # correction is second-order)
        m1 = torch.linalg.solve_triangular(lh, eh, upper=False)
        m = torch.linalg.solve_triangular(lh.mT, m1, upper=True, left=False)
        dl = lh @ _phi(m)
        lh, ll = df_add(lh, ll, dl, torch.zeros_like(dl))
        lh = torch.tril(lh)
        ll = torch.tril(ll)
    return lh, ll


def _panel_solve_df64(lkk_h, lkk_l, bh, bl, *, refine: int, gemm_kw) -> tuple:
    """Solve X·L_kkᵀ = B in df64: fp32 TRSM + df64-residual refinement."""

    def trsm(r):  # X·L_kkᵀ = R
        return torch.linalg.solve_triangular(lkk_h.mT, r, upper=True, left=False)

    xh = trsm(bh)
    xl = torch.zeros_like(xh)
    sl_l = slice_rows(lkk_h, lkk_l, s=gemm_kw.get("s", 6), w=gemm_kw.get("w", 8))[0]
    for _ in range(refine):
        ph, pl = df64_matmul_nt(xh, xl, lkk_h, lkk_l, slices_b=sl_l, **gemm_kw)
        rh, rl = df_sub(bh, bl, ph, pl)
        dx = trsm(rh)
        xh, xl = df_add(xh, xl, dx, torch.zeros_like(dx))
    return xh, xl


def potrf_df64(
    ah: torch.Tensor,
    al: torch.Tensor,
    *,
    nb: int = 1024,
    refine: int = 2,
    s: int = 7,
    w: int = 8,
    precise_deg: int = 3,
    trailing_strips: int = 4,
    trailing: str = "xla",
    tb: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Right-looking blocked df64 POTRF of the (hi, lo) pair → (Lh, Ll), the
    lower triangle (upper zeroed). ``nb`` must divide N. The accuracy knobs
    (s slices of w bits, ``precise_deg`` compensated cross-degree, ``refine``
    panel corrections) default to the reference's gate-safe configuration.

    **Factors in place** when the planes are fp32 and row-major: each panel
    lands in ``ah``/``al``, the trailing update runs on them, and the returned
    pair *is* ``(ah, al)`` with its strict upper triangle zeroed (the reference
    donates its pair to the same effect), so peak memory is the pair plus one
    panel's temporaries. Other inputs are copied to fp32 first.

    ``trailing="xla"`` runs the trailing update as ``trailing_strips``
    lower-trapezoid column strips of :func:`df64_matmul_nt`;
    ``trailing="pallas"`` runs the df64 trailing kernel over the ``tb``-tile
    lower-triangle pairs (one launch per panel step on the card).
    """
    n = ah.shape[0]
    if ah.shape != (n, n) or al.shape != (n, n):
        raise ValueError(f"need square (hi, lo) pair, got {tuple(ah.shape)}")
    if n % nb:
        raise ValueError(f"n={n} must be a multiple of nb={nb}")
    if trailing not in ("xla", "pallas"):
        raise ValueError(f"trailing must be 'xla' or 'pallas', got {trailing!r}")
    if trailing == "pallas" and (n % tb or nb % tb):
        raise ValueError(f"trailing='pallas' needs tb | nb | n (tb={tb})")
    gemm_kw = dict(s=s, w=w, precise_deg=precise_deg)
    ah = ah.to(_F32).contiguous()
    al = al.to(_F32).contiguous()
    for k in range(0, n, nb):
        k1 = k + nb
        lkk_h, lkk_l = _factor_diag_df64(ah[k:k1, k:k1], al[k:k1, k:k1], refine=refine,
                                         gemm_kw=gemm_kw)
        ah[k:k1, k:k1] = lkk_h
        al[k:k1, k:k1] = lkk_l
        if k1 == n:
            break
        xh, xl = _panel_solve_df64(lkk_h, lkk_l, ah[k1:, k:k1], al[k1:, k:k1],
                                   refine=refine, gemm_kw=gemm_kw)
        ah[k1:, k:k1] = xh
        al[k1:, k:k1] = xl
        # trailing: C ← C − X·Xᵀ. Slices are per-ROW scaled, so row sub-ranges
        # of the panel's slice set are themselves valid slice sets: the panel
        # is sliced ONCE and reused.
        h = n - k1
        # row-major for the kernel: a CUDA triangular solve returns X column-major
        sx = [x.contiguous() for x in slice_rows(xh, xl, s=s, w=w)[0]]
        if trailing == "pallas":
            trailing_update_df64(ah, al, sx, origin=k1 // tb, tb=tb, w=w,
                                 precise_deg=precise_deg)
            continue
        nstr = max(1, min(trailing_strips, h // nb))
        bounds = [(i * (h // nb) // nstr) * nb for i in range(nstr)] + [h]
        for i in range(nstr):
            j0, j1 = bounds[i], bounds[i + 1]
            th, tl = df64_matmul_nt(
                None, None, None, None,
                slices_a=[x[j0:] for x in sx], slices_b=[x[j0:j1] for x in sx],
                **gemm_kw)
            rows, cols = slice(k1 + j0, None), slice(k1 + j0, k1 + j1)
            ch, cl = df_sub(ah[rows, cols], al[rows, cols], th, tl)
            ah[rows, cols] = ch
            al[rows, cols] = cl
    return ah.tril_(), al.tril_()


def potrf_packed_df64(
    aph: torch.Tensor,
    apl: torch.Tensor,
    n: int,
    nb: int,
    *,
    ktb: int = 512,
    refine: int = 2,
    s: int = 7,
    w: int = 8,
    precise_deg: int = 3,
    k0: int = 0,
    k1: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Right-looking df64 POTRF **in packed space**: the (hi, lo) pair is two
    column-slab packed lower triangles (``algos/packed.py`` layout, slab width
    ``nb``), so the resident factor state is n·(n+nb) bytes ≈ 4·n² instead of
    the dense pair's 8·n². Per step: the df64 diagonal factor and panel solve
    of :func:`potrf_df64` (the slab's diagonal block is re-symmetrized there,
    since the packed trailing kernel updates lower-triangle tiles only), then
    one packed df64 trailing update over the pair
    (:func:`~dla_tpu_torch.kernels.df64_tiles.trailing_update_packed_df64`,
    tile ``ktb``: one kernel launch per step on the card). Returns the packed
    (Lh, Ll) pair; with ktb < nb the diagonal blocks of the slabs not yet
    factored carry stale tiles above the diagonal, as in the fp32
    ``potrf_packed``, and each step's diagonal factor overwrites its block
    with tril(L_kk).

    **Factors in place** when the planes are fp32 and contiguous: the returned
    pair *is* ``(aph, apl)`` (the reference donates its pair to the same
    effect). Other inputs are copied to fp32 first.

    ``k0``/``k1`` restrict execution to slab steps ``[k0, k1)``; steps
    ``[0, k0)`` must have run on the pair already
    (:func:`potrf_packed_df64_split`)."""
    _check_packed(n, nb)
    if nb % ktb:
        raise ValueError(f"need ktb | nb (nb={nb}, ktb={ktb})")
    gemm_kw = dict(s=s, w=w, precise_deg=precise_deg)
    nt = n // nb
    if k1 is None:
        k1 = nt
    if not 0 <= k0 <= k1 <= nt:
        raise ValueError(f"need 0 <= k0 <= k1 <= nt, got [{k0}, {k1})")
    aph = aph.to(_F32).contiguous()
    apl = apl.to(_F32).contiguous()
    for k in range(k0, k1):
        ch = col_slab(aph, k, n, nb)
        cl = col_slab(apl, k, n, nb)
        lkk_h, lkk_l = _factor_diag_df64(ch[:nb], cl[:nb], refine=refine, gemm_kw=gemm_kw)
        ch[:nb] = lkk_h
        cl[:nb] = lkk_l
        if k + 1 == nt:
            break
        xh, xl = _panel_solve_df64(lkk_h, lkk_l, ch[nb:], cl[nb:], refine=refine,
                                   gemm_kw=gemm_kw)
        ch[nb:] = xh
        cl[nb:] = xl
        # row-major for the kernel: a CUDA triangular solve returns X column-major
        sx = [x.contiguous() for x in slice_rows(xh, xl, s=s, w=w)[0]]
        trailing_update_packed_df64(aph, apl, sx, n=n, nb=nb, k=k, tb=ktb, w=w,
                                    precise_deg=precise_deg)
    return aph, apl


def potrf_packed_df64_split(
    aph: torch.Tensor,
    apl: torch.Tensor,
    n: int,
    nb: int,
    *,
    split: int = 2,
    ktb: int = 512,
    refine: int = 2,
    s: int = 7,
    w: int = 8,
    precise_deg: int = 3,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`potrf_packed_df64` executed as ``split`` segments of about
    nt/split slab steps each: the same step sequence, so the same bits as the
    monolith. The reference needs the segments to keep each jitted program
    under its compile service's size limit; eager torch has no such limit, and
    this is a plain loop over ``k0``/``k1`` ranges, kept so that both packages
    take the same calls.

    The pair is factored in place exactly as :func:`potrf_packed_df64` factors
    it: after the call the caller's fp32 contiguous planes hold the factor and
    are the returned pair. ``split=0`` auto-sizes as in the reference: the
    fewest segments of at most 40 steps each."""
    if split < 0:
        raise ValueError(f"split must be >= 0, got {split}")
    _check_packed(n, nb)
    nt = n // nb
    if split == 0:
        split = -(-nt // 40)
    split = min(split, nt)
    bounds = [round(i * nt / split) for i in range(split + 1)]
    for i in range(split):
        aph, apl = potrf_packed_df64(aph, apl, n, nb, ktb=ktb, refine=refine, s=s, w=w,
                                     precise_deg=precise_deg, k0=bounds[i], k1=bounds[i + 1])
    return aph, apl


def trmm_packed_df64(
    lph: torch.Tensor,
    lpl: torch.Tensor,
    xh: torch.Tensor,
    xl: torch.Tensor,
    n: int,
    nb: int,
    *,
    trans: bool = False,
    s: int = 7,
    w: int = 8,
    precise_deg: int = 3,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Y = L·X (or Lᵀ·X) in df64 from the **packed** factor pair: one df64
    GEMM per column slab, accumulated with compensated adds (the packed df64
    ``dtrmm``; the residual engine of the packed df64 solve). X is an
    (n, nrhs) df64 pair. Like the reference it reads each slab whole: the
    diagonal blocks must be lower-triangular, as those of a finished
    :func:`potrf_packed_df64` factor are (each step writes tril(L_kk))."""
    _check_packed(n, nb)
    gemm_kw = dict(s=s, w=w, precise_deg=precise_deg)
    yh = torch.zeros_like(xh)
    yl = torch.zeros_like(xl)
    for j in range(n // nb):
        ch = col_slab(lph, j, n, nb)
        cl = col_slab(lpl, j, n, nb)
        blk, tail = slice(j * nb, (j + 1) * nb), slice(j * nb, None)
        if not trans:  # y[j·nb:] += colj · x_j
            ph, pl = df64_matmul_nt(ch, cl, xh[blk].mT, xl[blk].mT, **gemm_kw)
            yh[tail], yl[tail] = df_add(yh[tail], yl[tail], ph, pl)
        else:  # y_j += coljᵀ · x[j·nb:]
            ph, pl = df64_matmul_nt(ch.mT, cl.mT, xh[tail].mT, xl[tail].mT, **gemm_kw)
            yh[blk], yl[blk] = df_add(yh[blk], yl[blk], ph, pl)
    return yh, yl


def potrs_packed_df64(
    lph: torch.Tensor,
    lpl: torch.Tensor,
    bh: torch.Tensor,
    bl: torch.Tensor,
    n: int,
    nb: int,
    *,
    refine: int = 2,
    s: int = 7,
    w: int = 8,
    precise_deg: int = 3,
    engine: str = "trmm",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve L·Lᵀ·X = B in df64 **from the packed factor pair**: the fp32
    packed substitution (:func:`dla_tpu_torch.algos.packed.potrs_packed` on
    the hi plane) plus ``refine`` steps of df64-residual correction, each one
    packed df64 L·(Lᵀ·x) reconstruction and one fp32 substitution — the scheme
    of the dense :func:`potrs_df64`. B is an (n, nrhs) df64 pair.

    ``engine`` selects the reconstruction: ``"trmm"`` = per-slab df64 GEMMs
    (:func:`trmm_packed_df64`), ``"matvec"`` = the tile loop of
    :func:`_packed_matvec_df64`."""
    gemm_kw = dict(s=s, w=w, precise_deg=precise_deg)
    if engine == "matvec":
        desc = _packed_tile_desc(n, nb)

        def recon(xh_, xl_):
            th, tl = _packed_matvec_df64(lph, lpl, desc, xh_, xl_, nb=nb, trans=True, **gemm_kw)
            return _packed_matvec_df64(lph, lpl, desc, th, tl, nb=nb, trans=False, **gemm_kw)
    else:
        def recon(xh_, xl_):
            th, tl = trmm_packed_df64(lph, lpl, xh_, xl_, n, nb, trans=True, **gemm_kw)
            return trmm_packed_df64(lph, lpl, th, tl, n, nb, trans=False, **gemm_kw)

    xh = potrs_packed(lph, bh, n, nb)
    xl = torch.zeros_like(xh)
    for _ in range(refine):
        ph, pl = recon(xh, xl)
        rh, _ = df_sub(bh, bl, ph, pl)
        dx = potrs_packed(lph, rh, n, nb)
        xh, xl = df_add(xh, xl, dx, torch.zeros_like(dx))
    return xh, xl


def potrs_df64(
    lh: torch.Tensor,
    ll: torch.Tensor,
    bh: torch.Tensor,
    bl: torch.Tensor,
    *,
    s: int = 7,
    w: int = 8,
    precise_deg: int = 3,
    refine: int = 2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve L·Lᵀ·X = B in df64 from a :func:`potrf_df64` factor (the
    reference's posv gate, ``v6_test.c:87``). Each substitution is an fp32
    triangular solve plus ``refine`` steps of df64-residual correction (one
    df64 GEMM and one fp32 TRSM per step, the scheme of the factor's panel
    solve). B is an (n, nrhs) df64 pair; returns the (Xh, Xl) pair."""
    gemm_kw = dict(s=s, w=w, precise_deg=precise_deg)

    def refine_solve(rh_in, rl_in, op_h, op_l, upper):
        """x ≈ OP⁻¹·r with df64-residual refinement; OP = L or Lᵀ as its
        df64 pair: the GEMM computes OP·x as A·Bᵀ with A = OP, B = xᵀ."""
        xh = torch.linalg.solve_triangular(op_h, rh_in, upper=upper)
        xl = torch.zeros_like(xh)
        for _ in range(refine):
            ph, pl = df64_matmul_nt(op_h, op_l, xh.mT, xl.mT, **gemm_kw)
            rh, _ = df_sub(rh_in, rl_in, ph, pl)
            dx = torch.linalg.solve_triangular(op_h, rh, upper=upper)
            xh, xl = df_add(xh, xl, dx, torch.zeros_like(dx))
        return xh, xl

    yh, yl = refine_solve(bh, bl, lh, ll, False)
    return refine_solve(yh, yl, lh.mT, ll.mT, True)


# ---------------------------------------------------------------------------
# df64 residual gates
# ---------------------------------------------------------------------------


def _df64_rowsum_max(h, l):
    """max_i Σ_j (|h| + |l|)[i, j] with a compensated column fold — the
    df64-grade ∞-norm bound of a (hi, lo) matrix."""
    acc_h = torch.zeros(h.shape[0], dtype=_F32, device=h.device)
    acc_l = torch.zeros_like(acc_h)
    for j in range(h.shape[1]):
        acc_h, e = two_sum(acc_h, h[:, j].abs() + l[:, j].abs())
        acc_l = acc_l + e
    return (acc_h + acc_l).max()


def residual_potrf_df64(
    ah, al, lh, ll, *, s: int = 7, w: int = 8, precise_deg: int = 3,
    row_chunk: int = 1024,
) -> torch.Tensor:
    """||A − L·Lᵀ||_inf / ||A||_inf evaluated in df64 on the tensors' device,
    an fp32 scalar (the value is ~1e-13, far above fp32's smallest normal).

    L is sliced once; the reconstruction runs one ``row_chunk``-row strip at a
    time against the whole slice set. The value floors at the GEMM's own
    method error (~n·2^(−s·w) relative): s=7 keeps it ~1e-12 at N≈64k, under
    the 1e-10 gate it certifies. Holds s·n² bf16 of slices: the blocked gate
    is for large N."""
    n = ah.shape[0]
    row_chunk = min(row_chunk, n)
    sl = slice_rows(lh, ll, s=s, w=w)[0]
    num = torch.zeros((), dtype=_F32, device=ah.device)
    for r0 in range(0, n, row_chunk):
        r1 = min(n, r0 + row_chunk)
        ph, pl = df64_matmul_nt(None, None, None, None, slices_a=[x[r0:r1] for x in sl],
                                slices_b=sl, s=s, w=w, precise_deg=precise_deg)
        rh, rl = df_sub(ah[r0:r1], al[r0:r1], ph, pl)
        num = torch.maximum(num, _df64_rowsum_max(rh, rl))
    return num / _df64_rowsum_max(ah, al)


def _slice_strip_tril(lh_s, ll_s, r0: int, *, s: int, w: int):
    """Slice a row strip of L (global first row ``r0``) with an explicit tril
    mask: it enforces the lower-triangle contract and makes the strip's columns
    beyond its last row exactly zero."""
    rc, n = lh_s.shape
    cols = torch.arange(n, device=lh_s.device)[None, :]
    rows = r0 + torch.arange(rc, device=lh_s.device)[:, None]
    mask = cols <= rows
    zh = torch.where(mask, lh_s, 0.0)
    zl = torch.where(mask, ll_s, 0.0)
    return slice_rows(zh, zl, s=s, w=w)[0]


def _residual_block(ah_b, al_b, si, sj, *, s: int, w: int, precise_deg: int):
    """One (rc, rc) block of |A − L·Lᵀ| (|h|+|l| overbound, matching
    :func:`_df64_rowsum_max`): (row sums, column sums) in fp32. ``al_b=None``:
    A is exactly fp32 and its lo plane is zero."""
    ph, pl = df64_matmul_nt(None, None, None, None, slices_a=si, slices_b=sj,
                            s=s, w=w, precise_deg=precise_deg)
    if al_b is None:
        al_b = torch.zeros_like(ah_b)
    rh, rl = df_sub(ah_b, al_b, ph, pl)
    r = rh.abs() + rl.abs()
    return r.sum(dim=1), r.sum(dim=0)


def _strip_abs_rowsums(h, l):
    a = h.abs()
    if l is not None:
        a = a + l.abs()
    return a.sum(dim=1)


def residual_potrf_df64_blocked(
    ah, al, lh, ll, *, s: int = 7, w: int = 8, precise_deg: int = 3,
    rc: int = 2048, gen_seed: int | None = None, bump: float | None = None,
) -> float:
    """||A − L·Lᵀ||_inf / ||A||_inf in df64 on the tensors' device, block-tiled
    so the full slice set of L is never resident (peak slice memory 2·s·rc·n
    bf16 instead of s·n²).

    Sweeps (rc, rc) blocks of R = A − L·Lᵀ over the LOWER triangle only; each
    block contracts two tril-masked row strips of L sliced on the fly. A and
    L·Lᵀ are both symmetric, so a lower block (i, j), i > j, also supplies the
    mirrored upper contributions through its column sums, which assumes A is
    bit-level symmetric (true of every generated input). Row sums accumulate
    in fp64. ``al=None``: A is exactly fp32 and no zeros plane is allocated.
    ``gen_seed``: A is streamed block by block from the seeded generator
    (``plgsy_tile``, fp32, diagonal ``bump``, default n) and ``ah``/``al`` are
    ignored; needs rc | n."""
    gen = gen_seed is not None
    n = lh.shape[0]
    dev = lh.device
    rc = min(rc, n)
    if gen:
        if n % rc:
            raise ValueError(f"generator-streamed gate needs rc | n (rc={rc}, n={n})")
        if bump is None:
            bump = float(n)
    nst = -(-n // rc)
    rowsum = torch.zeros(n, dtype=torch.float64, device=dev)
    anorm = torch.zeros(n, dtype=torch.float64, device=dev)
    for i in range(nst):
        r0, r1 = i * rc, min(n, (i + 1) * rc)
        si = _slice_strip_tril(lh[r0:r1], ll[r0:r1], r0, s=s, w=w)
        if gen:
            strip = plgsy_tile(gen_seed, r0, 0, r1 - r0, n, bump=bump, device=dev)
            anorm[r0:r1] = _strip_abs_rowsums(strip, None).double()
            del strip
        else:
            anorm[r0:r1] = _strip_abs_rowsums(ah[r0:r1], None if al is None else al[r0:r1]).double()
        for j in range(i + 1):
            c0, c1 = j * rc, min(n, (j + 1) * rc)
            sj = si if j == i else _slice_strip_tril(lh[c0:c1], ll[c0:c1], c0, s=s, w=w)
            if gen:
                ah_b = plgsy_tile(gen_seed, r0, c0, r1 - r0, c1 - c0, bump=bump, device=dev)
                al_b = None
            else:
                ah_b = ah[r0:r1, c0:c1]
                al_b = None if al is None else al[r0:r1, c0:c1]
            rs, cs = _residual_block(ah_b, al_b, si, sj, s=s, w=w, precise_deg=precise_deg)
            rowsum[r0:r1] += rs.double()
            if j < i:
                rowsum[c0:c1] += cs.double()
    return float(rowsum.max() / anorm.max())


# ---------------------------------------------------------------------------
# streaming df64 Freivalds gates
# ---------------------------------------------------------------------------


def _probes(seed: int, shape, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The gates' probe block, numpy's standard normals rounded to fp32 (the
    reference's draw, so both packages probe with the same vectors), as a
    df64 pair with a zero lo plane on ``device``."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    xh = torch.from_numpy(x).to(device)
    return xh, torch.zeros_like(xh)


def _matvec_df64(mh, ml, xth, xtl, *, s, w, precise_deg, row_chunk):
    """Full df64 matvec M·X (X given transposed: an (nrhs, k) pair) by row
    strips, which keeps the slice memory O(row_chunk·k). ``ml=None`` means
    the lo plane is exactly zero."""
    outs_h, outs_l = [], []
    for r0 in range(0, mh.shape[0], row_chunk):
        mh_s = mh[r0 : r0 + row_chunk]
        ml_s = torch.zeros_like(mh_s) if ml is None else ml[r0 : r0 + row_chunk]
        h, l = df64_matmul_nt(mh_s, ml_s, xth, xtl, s=s, w=w, precise_deg=precise_deg)
        outs_h.append(h)
        outs_l.append(l)
    return torch.cat(outs_h), torch.cat(outs_l)


def _matvec_t_df64(mh, ml, xth, xtl, *, s, w, precise_deg, row_chunk):
    """Full df64 matvec Mᵀ·X by row strips of M, each transposed as a view and
    accumulated with compensated adds: no (n, n) transposed copy of a plane is
    ever made. X given transposed (an (nrhs, m) pair); returns the (k, nrhs)
    result pair."""
    m, k = mh.shape
    acc_h = torch.zeros((k, xth.shape[0]), dtype=_F32, device=mh.device)
    acc_l = torch.zeros_like(acc_h)
    for r0 in range(0, m, row_chunk):
        rows = slice(r0, r0 + row_chunk)
        h, l = df64_matmul_nt(mh[rows].mT, ml[rows].mT, xth[:, rows], xtl[:, rows],
                              s=s, w=w, precise_deg=precise_deg)
        acc_h, acc_l = df_add(acc_h, acc_l, h, l)
    return acc_h, acc_l


def _abs_rowsum_max(h, row_chunk: int):
    """max_i Σ_j |h[i, j]| in fp32, one row strip's |h| at a time."""
    return torch.stack([h[r0 : r0 + row_chunk].abs().sum(dim=1).max()
                        for r0 in range(0, h.shape[0], row_chunk)]).max()


def freivalds_potrf_df64(
    lh, ll, ah, al=None, *, probes: int = 2, seed: int = 71,
    s: int = 7, w: int = 8, precise_deg: int = 3, row_chunk: int = 1024,
) -> torch.Tensor:
    """Streaming Freivalds gate for a dense df64 factor:
    ``max_p ||(A − L·Lᵀ)·x_p||_inf / (||A||_inf·||x_p||_inf)`` with every
    matvec in df64 — O(n²) work and O(row_chunk·n) slice memory, where the
    full reconstruction residual is O(n³). ``al=None``: A is exactly fp32.
    Returns an fp32 scalar on the factor's device."""
    xth, xtl = _probes(seed, (probes, lh.shape[0]), lh.device)
    kw = dict(s=s, w=w, precise_deg=precise_deg, row_chunk=row_chunk)
    zh, zl = _matvec_t_df64(lh, ll, xth, xtl, **kw)  # z = Lᵀ·x
    wh, wl = _matvec_df64(lh, ll, zh.mT, zl.mT, **kw)  # L·z
    yh, yl = _matvec_df64(ah, al, xth, xtl, **kw)  # A·x
    rh, rl = df_sub(yh, yl, wh, wl)
    num = (rh + rl).abs().max()
    anorm = _abs_rowsum_max(ah, row_chunk) if al is None else _df64_rowsum_max(ah, al)
    return num / (anorm * xth.abs().max())


def _gen_strip_matvec_df64(seed, i0, xth, xtl, *, rows, cols, bump, s, w, precise_deg):
    """One generated row strip of the seeded SPD matrix times the probe block,
    in df64: A[i0:i0+rows, :] is made on the fly (``plgsy_tile``), so no (n, n)
    A plane is ever resident. Returns the (hi, lo) product strip and the
    strip's |A| row sums (its share of ||A||_inf)."""
    strip = plgsy_tile(seed, i0, 0, rows, cols, bump=bump, device=xth.device)
    h, l = df64_matmul_nt(strip, torch.zeros_like(strip), xth, xtl, s=s, w=w,
                          precise_deg=precise_deg)
    return h, l, strip.abs().sum(dim=1)


def _packed_tile_desc(n: int, nb: int) -> np.ndarray:
    """Descriptor table for :func:`_packed_matvec_df64`: one row per (nb, nb)
    tile of the packed triangle — (plane row offset, global row, column
    base)."""
    nt = n // nb
    rows = []
    r0 = 0
    for j in range(nt):
        for i in range(j, nt):
            rows.append((r0 + (i - j) * nb, i * nb, j * nb))
        r0 += (nt - j) * nb
    return np.asarray(rows, np.int64)


def _packed_matvec_df64(ph, pl, desc, xh, xl, *, nb, s, w, precise_deg, trans):
    """Full df64 matvec L·X (or Lᵀ·X) **directly off the packed column-slab
    pair**: a loop over the triangle's nt(nt+1)/2 (nb, nb) tiles, addressed by
    ``desc`` (:func:`_packed_tile_desc`). Per tile: the (hi, lo) tile as a view
    (diagonal tiles tril-masked, since packed factors carry stale upper-tile
    garbage), one tile-sized df64 GEMM against the probe slice, a compensated
    accumulation into the (n, probes) output pair. Peak transient memory is
    tile-sized: the pair is never unpacked and no dense A is needed."""
    oh = torch.zeros_like(xh)
    ol = torch.zeros_like(xl)
    kw = dict(s=s, w=w, precise_deg=precise_deg)
    for r0, g0, jb in desc.tolist():
        th, tl = ph[r0 : r0 + nb], pl[r0 : r0 + nb]
        if g0 == jb:
            th, tl = torch.tril(th), torch.tril(tl)
        if trans:  # z[jb:jb+nb] += tileᵀ · x[g0:g0+nb]
            hh, ll_ = df64_matmul_nt(th.mT, tl.mT, xh[g0 : g0 + nb].mT, xl[g0 : g0 + nb].mT, **kw)
            o = slice(jb, jb + nb)
        else:  # y[g0:g0+nb] += tile · x[jb:jb+nb]
            hh, ll_ = df64_matmul_nt(th, tl, xh[jb : jb + nb].mT, xl[jb : jb + nb].mT, **kw)
            o = slice(g0, g0 + nb)
        oh[o], ol[o] = df_add(oh[o], ol[o], hh, ll_)
    return oh, ol


def _streamed_ax_gate(yh, yl, xth, xtl, n, *, gen_seed, bump, s, w, precise_deg, row_chunk):
    """max_strip ||A·x − y||_inf and ||A||_inf with A streamed from the seeded
    generator (the shared tail of both streaming gates below), as floats."""
    num = 0.0
    anorm = 0.0
    for r0 in range(0, n, row_chunk):
        h, l, rs = _gen_strip_matvec_df64(gen_seed, r0, xth, xtl, rows=row_chunk, cols=n,
                                          bump=bump, s=s, w=w, precise_deg=precise_deg)
        rh, rl = df_sub(h, l, yh[r0 : r0 + row_chunk], yl[r0 : r0 + row_chunk])
        num = max(num, float((rh + rl).abs().max()))
        anorm = max(anorm, float(rs.max()))
    return num, anorm


def freivalds_packed_df64(
    lph, lpl, n: int, nb: int, *, probes: int = 2, seed: int = 71,
    gen_seed: int = 51, bump: float | None = None,
    s: int = 7, w: int = 8, precise_deg: int = 3, row_chunk: int = 1024,
) -> float:
    """Streaming df64 Freivalds gate **for a packed factor pair, with no
    unpack and no dense A**: ``max_p ||(A − L·Lᵀ)·x_p||_inf /
    (||A||_inf·||x_p||_inf)`` where L·(Lᵀ·x) runs directly off the packed
    column slabs (:func:`_packed_matvec_df64`) and A — the seeded exactly-fp32
    generator matrix that ``plgsy_packed`` packs — is streamed strip-wise from
    its seed. Peak extra device memory is strip-sized."""
    if n % nb:
        raise ValueError(f"n={n} must be a multiple of nb={nb}")
    if n % row_chunk:
        raise ValueError(f"row_chunk={row_chunk} must divide n={n}")
    if bump is None:
        bump = float(n)
    xh, xl = _probes(seed, (n, probes), lph.device)
    desc = _packed_tile_desc(n, nb)
    kw = dict(s=s, w=w, precise_deg=precise_deg)
    zh, zl = _packed_matvec_df64(lph, lpl, desc, xh, xl, nb=nb, trans=True, **kw)
    yh, yl = _packed_matvec_df64(lph, lpl, desc, zh, zl, nb=nb, trans=False, **kw)
    num, anorm = _streamed_ax_gate(yh, yl, xh.mT, xl.mT, n, gen_seed=gen_seed, bump=bump,
                                   row_chunk=row_chunk, **kw)
    return num / (anorm * float(xh.abs().max()))


def freivalds_potrf_df64_gen(
    lh, ll, *, probes: int = 2, seed: int = 71, gen_seed: int = 51,
    bump: float | None = None, s: int = 7, w: int = 8,
    precise_deg: int = 3, row_chunk: int = 1024,
) -> float:
    """:func:`freivalds_potrf_df64` for a dense factor pair of the seeded
    generator matrix, with A streamed from its seed instead of resident: the
    same probes and the same quantity without the (n, n) A plane."""
    n = lh.shape[0]
    if n % row_chunk:
        raise ValueError(f"row_chunk={row_chunk} must divide n={n}")
    if bump is None:
        bump = float(n)
    xth, xtl = _probes(seed, (probes, n), lh.device)
    kw = dict(s=s, w=w, precise_deg=precise_deg)
    zh, zl = _matvec_t_df64(lh, ll, xth, xtl, row_chunk=row_chunk, **kw)  # z = Lᵀ·x
    yh, yl = _matvec_df64(lh, ll, zh.mT, zl.mT, row_chunk=row_chunk, **kw)
    num, anorm = _streamed_ax_gate(yh, yl, xth, xtl, n, gen_seed=gen_seed, bump=bump,
                                   row_chunk=row_chunk, **kw)
    return num / (anorm * float(xth.abs().max()))
