"""Blocked Cholesky in emulated fp64 (df64) and its df64 residual gates —
counterpart of the dense part of ``dla_tpu/algos/potrf_df64.py``.

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

The gates measure ``||A − L·Lᵀ||_inf / ||A||_inf`` in df64 on the tensors'
device: :func:`residual_potrf_df64` holds the whole slice set of L,
:func:`residual_potrf_df64_blocked` only two row strips of it, and can stream A
from its seed. The reference splits these into jitted strip programs for its
remote compiler; here they are plain loops, and the same quantity comes out.

Not ported yet (``ROADMAP.md``): the packed df64 factor and kernel, the df64
solves and the df64 Freivalds gates.
"""

from __future__ import annotations

import torch

from dla_tpu_torch.algos.potrf import _cholesky
from dla_tpu_torch.kernels.df64_tiles import trailing_update_df64
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
