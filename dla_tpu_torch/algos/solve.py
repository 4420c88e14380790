"""Solve path — counterpart of ``dla_tpu/algos/solve.py``: POTRS (two
triangular solves), POSV, and mixed-precision iterative refinement.

Factor in a fast precision (fp32 on the card), then recover a solution whose
backward error sits at the wide precision's roundoff by classical iterative
refinement:

    x0 = L^-T L^-1 b          (low-precision factor)
    repeat: r = b - A x       (fp64 residual)
            d = L^-T L^-1 r   (low-precision correction solve)
            x += d

It converges to a backward error at fp64's roundoff as long as A is not too
ill-conditioned for the factor's precision: ≤ 1e-10 solve residuals from fp32
factors. The H100 has native fp64, so the refinement's residual runs on the
card in both :func:`posv_refined` and :func:`posv_refined_host` (which keeps
the JAX package's name: there the residual ran on the host, since its TPU
degrades fp64). Every solve reads only tril(L). :func:`posv_refined_streamed`
serves N where A is never materialized anywhere: its fp64 residuals stream A
from the native host generator panel by panel.
"""

from __future__ import annotations

import numpy as np
import torch

from dla_tpu_torch.algos.potrf import potrf_blocked, potrf_shrink
from dla_tpu_torch.ops import gemm, trsm


def _solve_lower_blocked(l: torch.Tensor, b: torch.Tensor, *, trans: bool, ib: int = 512):
    """Left triangular solve L·X = B (or Lᵀ·X = B / Lᴴ·X = B) with only the
    ib×ib diagonal blocks inverted; everything else is GEMMs at the active
    precision tier. Reads the lower triangle of ``l`` only. bf16 factors
    solve in fp32, their operand slices upcast block by block."""
    n = l.shape[-1]
    ib = min(ib, n)
    cj = l.is_complex()
    ct = torch.float32 if l.dtype == torch.bfloat16 else l.dtype
    b = b.to(ct)
    eye = torch.eye(ib, dtype=ct, device=l.device)
    x = torch.zeros_like(b)
    blocks = list(range(0, n, ib))
    for off in blocks[::-1] if trans else blocks:
        w = min(ib, n - off)
        blk = slice(off, off + w)
        dinv = trsm(1.0, l[blk, blk].to(ct), eye[:w, :w], side="L", transa=False)
        rhs = b[blk]
        if not trans and off:
            rhs = gemm(-1.0, l[blk, :off].to(ct), x[:off], 1.0, rhs)
        elif trans and off + w < n:
            # (op(L))_{ij} = op(L_ji) for j > i in the transposed solve
            rhs = gemm(-1.0, l[off + w :, blk].to(ct), x[off + w :], 1.0, rhs,
                       transa=True, conja=cj)
        x[blk] = gemm(1.0, dinv, rhs, 0.0, torch.zeros_like(rhs), transa=trans,
                      conja=trans and cj)
    return x


def potrs(l: torch.Tensor, b: torch.Tensor, *, blocked: bool | None = None,
          ib: int = 512) -> torch.Tensor:
    """Solve A·X = B given A = L·Lᵀ (L·Lᴴ for complex): forward then back
    substitution, as LAPACK ``dpotrs``. ``b`` is (n,) or (n, nrhs).

    ``blocked`` (default: auto, n ≥ 2048) takes the block-inverse solves of
    :func:`_solve_lower_blocked` (ib×ib diagonal inverses, the rest GEMMs)
    instead of two ``torch.linalg.solve_triangular`` calls; ``ib`` is their
    block size. bf16 factors solve in fp32. Reads only tril(``l``)."""
    vec = b.ndim == 1
    bb = b[:, None] if vec else b
    cj = l.is_complex()
    if blocked is None:
        blocked = l.shape[-1] >= 2048
    if blocked:
        y = _solve_lower_blocked(l, bb, trans=False, ib=ib)
        x = _solve_lower_blocked(l, y, trans=True, ib=ib)
    else:
        ls = l.float() if l.dtype == torch.bfloat16 else l
        bb = bb.to(ls.dtype)
        y = trsm(1.0, ls, bb, side="L", uplo="L", transa=False)
        x = trsm(1.0, ls, y, side="L", uplo="L", transa=True, conja=cj)
    return x[:, 0] if vec else x


def potrs_batched(l: torch.Tensor, b: torch.Tensor, **kw) -> torch.Tensor:
    """POTRS over leading batch axes: (..., n, n) factors and (..., n, nrhs)
    right-hand sides, one :func:`potrs` per matrix (``**kw`` forwarded; the
    ``blocked`` threshold applies per matrix)."""
    batch_shape, n, nrhs = l.shape[:-2], l.shape[-1], b.shape[-1]
    if b.shape[:-2] != batch_shape or b.shape[-2] != n:
        raise ValueError(f"batch/shape mismatch: {tuple(l.shape)} vs {tuple(b.shape)}")
    lf, bf = l.reshape(-1, n, n), b.reshape(-1, n, nrhs)
    out = torch.stack([potrs(li, bi, **kw) for li, bi in zip(lf, bf)]) if len(lf) else bf.clone()
    return out.reshape(*batch_shape, n, nrhs)


def posv(a: torch.Tensor, b: torch.Tensor, *, nb: int = 256, **kw):
    """Factor and solve (LAPACK ``dposv``): ``potrf_blocked(a, nb=nb, **kw)``
    then :func:`potrs`. Returns (L, X). Reads only tril(``a``)."""
    l = potrf_blocked(a, nb=nb, **kw)
    return l, potrs(l, b)


def _symmetrize_lower(a: torch.Tensor) -> torch.Tensor:
    return torch.tril(a) + torch.tril(a, -1).mT


def posv_refined(a: torch.Tensor, b: torch.Tensor, *, nb: int = 256,
                 factor_dtype: torch.dtype = torch.float32,
                 wide_dtype: torch.dtype | None = None, iters: int = 8):
    """Mixed-precision POSV: factor tril(A), symmetrized, in ``factor_dtype``
    with :func:`~dla_tpu_torch.algos.potrf.potrf_blocked`, then ``iters``
    refinement steps with the residual in ``wide_dtype`` (default float64:
    the JAX package's choice under x64, which the card has natively).

    Returns (L in ``factor_dtype``, X in ``wide_dtype``, max|B − A·X|)."""
    wide = torch.float64 if wide_dtype is None else wide_dtype
    aw = _symmetrize_lower(a).to(wide)
    bw = b.to(wide)
    l = potrf_blocked(aw.to(factor_dtype), nb=nb)

    def solve_low(r):
        return potrs(l, r.to(factor_dtype)).to(wide)

    x = solve_low(bw)
    for _ in range(iters):
        x = x + solve_low(bw - aw @ x)
    r = bw - aw @ x
    return l, x, r.abs().max()


def posv_refined_host(a_host, b_host, *, nb: int = 2048, iters: int = 12, tol: float = 1e-11,
                      potrf_kwargs: dict | None = None, device=None):
    """Mixed-precision POSV with an fp32 factor and fp64 residuals, stopping
    early once the normwise backward error ||b − A·x|| / (||A||·||x||) drops
    below ``tol``.

    ``a_host``: (n, n) float64 array or tensor, symmetric data in its lower
    triangle (the upper is ignored); ``b_host``: (n,) or (n, nrhs). The fp32
    factor is ``potrf_shrink(nb=nb, **potrf_kwargs)``; the correction solves
    are :func:`potrs` of it, the residuals fp64. Everything runs on
    ``device``: by default ``a_host``'s, if it is a CUDA tensor, else the
    card (``device="cpu"`` for the CPU). The JAX package computes the
    residual on its host instead, because its TPU degrades fp64; the H100
    has native fp64, so here only the scalars come back.

    Returns (x, backward error, iterations used): x float64 on ``device``,
    shaped as ``b_host``."""
    if device is None:
        device = a_host.device if torch.is_tensor(a_host) and a_host.is_cuda else "cuda"

    def f64(x):
        x = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x, np.float64))
        return x.to(device=device, dtype=torch.float64)

    asym = _symmetrize_lower(f64(a_host))
    vec = np.ndim(b_host) == 1
    b64 = f64(b_host).reshape(asym.shape[0], -1)
    l = potrf_shrink(asym.float(), nb=nb, **(potrf_kwargs or {}))

    norm_a = asym.abs().sum(dim=1).max()
    x = torch.zeros_like(b64)
    r = b64.clone()
    err, used = float("inf"), 0
    for i in range(iters):
        x += potrs(l, r.float()).double()
        r = b64 - asym @ x
        used = i + 1
        err = float(r.abs().max() / (norm_a * torch.clamp(x.abs().max(), min=1e-300)))
        if err < tol:
            break
    return (x[:, 0] if vec else x), err, used


def posv_refined_streamed(l, b_host, *, seed: int = 51, bump: float | None = None,
                          panel: int = 4096, iters: int = 16, tol: float = 1e-11,
                          on_iter=None, solver=None, n: int | None = None):
    """:func:`posv_refined_host` for A = plgsy(n, seed, bump) where A is
    never materialized, on the card or the host: the fp64 residual
    ``r = b − A·x`` streams A from the native generator (``dla_plgsy_f64``,
    the card generator's bits) panel by panel through ONE pooled fp64
    buffer, using symmetry so that only the lower panels are generated. Per
    refinement iteration the host does O(N²) fp64 generate+FMA work; the
    correction solves run where ``l`` lies, against the low-precision factor
    (fp32 or bf16: ``potrs`` solves a bf16 factor in fp32).

    Args:
      l: factor of the plgsy(seed, bump) matrix (lower triangle meaningful),
        any storage dtype, on the device the solves run on.
      b_host: (n,) or (n, nrhs) float64 right-hand side (array or tensor).
      solver: optional correction solve ``(r_f32) -> d`` replacing the
        default ``potrs(l, r)`` — e.g. a packed-factor solve
        (``potrs_packed``), whose buffer shape hides n (pass ``n`` too).
      n: matrix dimension when it cannot be read off ``l.shape`` (packed
        factors).

    Returns (x as a float64 numpy array shaped as ``b_host``, backward error
    ``||b − A·x||_inf / (||A||_inf·||x||_inf)``, iterations used) — the
    reference's solve gate is err ≤ 1e-10 (BASELINE config 3).
    """
    from dla_tpu_torch.runtime.staging import _aligned_empty, lib as _native

    if n is None:
        n = l.shape[-1]
    if n % panel:
        raise ValueError(f"n={n} must be a multiple of panel={panel}")
    if bump is None:
        bump = float(n)
    gen = _native().dla_plgsy_f64
    work = _aligned_empty(n * panel * 8).view(np.float64)

    b_np = b_host.detach().cpu().numpy() if torch.is_tensor(b_host) else b_host
    vec = np.ndim(b_np) == 1
    b64 = np.asarray(b_np, np.float64).reshape(n, -1)

    def stream_a(apply):
        """apply(k0, a_panel) for each lower panel (rows k0.., cols
        k0..k0+panel) of the fp64 generator output."""
        for k0 in range(0, n, panel):
            h = n - k0
            a = work[: h * panel].reshape(h, panel)
            gen(a.ctypes.data, panel, seed & 0xFFFFFFFF, k0, k0, h, panel, bump)
            apply(k0, a)

    # ||A||_inf via streaming row sums (symmetric contributions)
    rowsum = np.zeros(n)

    def _norm(k0, a):
        rowsum[k0:] += np.abs(a).sum(axis=1)
        rowsum[k0 : k0 + panel] += np.abs(a[panel:]).sum(axis=0)

    stream_a(_norm)
    norm_a = rowsum.max()

    def matvec(x):
        y = np.zeros_like(x)

        def _mv(k0, a):
            y[k0:] += a @ x[k0 : k0 + panel]
            y[k0 : k0 + panel] += a[panel:].T @ x[k0 + panel :]

        stream_a(_mv)
        return y

    if solver is None:
        solver = lambda r32: potrs(l, r32)  # noqa: E731
    x = np.zeros_like(b64)
    r = b64.copy()
    err, used = np.inf, 0
    for i in range(iters):
        r32 = torch.from_numpy(r.astype(np.float32)).to(l.device)
        x += solver(r32).double().cpu().numpy()
        r = b64 - matvec(x)  # host fp64, streamed from the generator
        used = i + 1
        err = np.abs(r).max() / (norm_a * max(np.abs(x).max(), 1e-300))
        if on_iter:
            on_iter(i, err)
        if err < tol:
            break
    return (x[:, 0] if vec else x), float(err), used
