"""The tile schedule of ``csrc/diag_block.cuh`` (the diagonal block of
``panel_factor`` and all of ``potrf_tile``), written as torch ops on the CPU
and held to the bits of the plain versions ``_factor_lower_plain`` and
``_invert_lower_plain``.

The kernel cuts the n×n block into b×b tiles (nt = ⌈n/b⌉, a ragged last
tile) and runs nt + 1 launches: launch t holds factor stage t and inverse
stage t − 1, whose blocks touch disjoint tiles, so the model below runs the
factor's stages, then the inverse's, each stage's blocks one after another:

- factor stage K: a *panel* block for each tile (I, K), I ≥ K, applies tile
  column K−1 to its tile and to the diagonal tile (K, K), factors the
  diagonal tile by b rank-1 steps and solves its rows against it; a
  *trailing* block for each tile (I, J), I ≥ J > K, applies tile column K−1
  to it. The partial sums live in a scratch matrix here (in the kernel, in
  L's and X's own storage).
- inverse stage J: a panel block for each tile (J, C), C ≤ J, applies tile
  row J−1 of X, then substitutes its columns against L_JJ; a trailing block
  for each tile (I, C), I > J > C, applies tile row J−1. A tile starts from
  the identity on its first touch.

Every element thus meets the same operations, in the same order, as in the
one-column-at-a-time plain versions: its products in ascending j, then its
division. The model gives their bits, so the kernel, which computes what
the model computes with the same correctly rounded operations, gives them
too. Inputs from a numpy seed; the upper triangle is NaN, which no stage
may read.
"""

import numpy as np
import pytest
import torch

from dla_tpu_torch.kernels import tiles
from dla_tpu_torch.ops.lapack_like import _sqrt_rn
from dla_tpu_torch.utils import precision
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

op = tiles._round_operand


def _rows(t, b, n):
    return slice(t * b, min(t * b + b, n))


def _apply(v, a, bt, kmin_col=False):
    """v − Σ_k op(a[:, k])·op(bt[:, k])ᵀ in ascending k, each term rounded;
    with ``kmin_col``, term k only reaches columns c ≤ k (the inverse's
    diagonal source tile: x[r][c] takes j ≥ c only)."""
    for k in range(a.shape[1]):
        upd = torch.outer(op(a[:, k]), op(bt[:, k]))
        if kmin_col:
            v[:, : k + 1] = v[:, : k + 1] - upd[:, : k + 1]
        else:
            v = v - upd
    return v


def _factor_diag(d):
    """The diagonal tile's factor in place: the plain version's rank-1 steps."""
    for j in range(d.shape[0]):
        piv = _sqrt_rn(d[j, j])
        col = d[j + 1 :, j] / piv
        d[j + 1 :, j] = col
        d[j, j] = piv
        s = op(col)
        d[j + 1 :, j + 1 :] -= torch.outer(s, s)
    return torch.tril(d)


def _solve_rows(t, d):
    """Each row of t against the factored diagonal tile d: divide by the
    pivot, then update the columns to its right."""
    for j in range(d.shape[0]):
        t[:, j] = t[:, j] / d[j, j]
        t[:, j + 1 :] -= torch.outer(op(t[:, j]), op(d[j + 1 :, j]))
    return t


def _solve_cols(t, l, diag):
    """Each column c of t against L_JJ (l): row j divided by l[j][j], then the
    rows below it updated; on a diagonal tile only columns c ≤ j take step j."""
    for j in range(l.shape[0]):
        c = slice(0, j + 1) if diag else slice(None)
        t[j, c] = t[j, c] / l[j, j]
        t[j + 1 :, c] -= torch.outer(op(l[j + 1 :, j]), op(t[j, c]))
    return t


def tiled_factor_invert(a, b):
    """(tril(L), inv(L)) of ``a`` through the kernel's stages, lower triangle read only."""
    n = a.shape[0]
    nt = -(-n // b)
    w = torch.tril(a)  # the scratch of partial sums; the upper triangle is never read
    l = torch.zeros_like(a)
    rows = lambda t: _rows(t, b, n)  # noqa: E731
    for k in range(nt):  # factor stage k
        kk, prev = rows(k), rows(k - 1)
        d = w[kk, kk].clone()
        if k:
            d = torch.tril(_apply(d, l[kk, prev], l[kk, prev]))
        d = _factor_diag(d)
        panel = {}
        for i in range(k + 1, nt):
            t = w[rows(i), kk].clone()
            if k:
                t = _apply(t, l[rows(i), prev], l[kk, prev])
            panel[i] = _solve_rows(t, d)
        trailing = {}
        if k:
            for j in range(k + 1, nt):
                for i in range(j, nt):
                    t = _apply(w[rows(i), rows(j)].clone(), l[rows(i), prev], l[rows(j), prev])
                    trailing[i, j] = torch.tril(t) if i == j else t
        l[kk, kk] = d
        for i, t in panel.items():
            l[rows(i), kk] = t
        for (i, j), t in trailing.items():
            w[rows(i), rows(j)] = t
    x = torch.zeros_like(a)
    for j in range(nt):  # inverse stage j
        jj, prev = rows(j), rows(j - 1)
        out = {}
        for c in range(j + 1):  # panel blocks
            t = x[jj, rows(c)].clone()  # a partial sum from stage j - 1 when j ≥ c + 2
            if j <= c + 1:  # the first touch: the identity's tile
                t = torch.eye(*t.shape, dtype=a.dtype) if j == c else torch.zeros_like(t)
            if j >= c + 1:
                t = _apply(t, l[jj, prev], x[prev, rows(c)].mT, kmin_col=j - 1 == c)
            out[j, c] = _solve_cols(t, l[jj, jj], diag=j == c)
        for i in range(j + 1, nt):  # trailing blocks
            for c in range(j):
                t = torch.zeros_like(x[rows(i), rows(c)]) if j - 1 == c else x[rows(i), rows(c)]
                out[i, c] = _apply(t.clone(), l[rows(i), prev], x[prev, rows(c)].mT,
                                   kmin_col=j - 1 == c)
        for (i, c), t in out.items():
            x[rows(i), rows(c)] = torch.tril(t) if i == c else t
    return l, x


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


CASES = [(dtype, prec) for dtype, prec in ((np.float32, "highest"), (np.float32, "high"),
                                           (np.float32, "default"), (np.float64, "high"))]


@pytest.mark.parametrize("dtype,prec", CASES, ids=[f"{np.dtype(d).name}-{p}" for d, p in CASES])
@pytest.mark.parametrize("b", [16, 32, 64])
@pytest.mark.parametrize("n", [1, 50, 64, 96, 130, 256])
def test_tile_schedule_gives_the_plain_bits(n, b, dtype, prec):
    rng = np.random.default_rng(1000 * n + b)
    g = rng.standard_normal((n, n))
    a = (g @ g.T + n * np.eye(n)).astype(dtype)
    a[np.triu_indices(n, 1)] = np.nan  # never read
    a = torch.from_numpy(a)
    with precision.override(prec):
        lref = tiles._factor_lower_plain(a)
        xref = tiles._invert_lower_plain(lref)
        l, x = tiled_factor_invert(a, b)
    assert bool(torch.isfinite(lref).all() and torch.isfinite(xref).all())
    assert torch.equal(_bits(l), _bits(lref))
    assert torch.equal(_bits(x), _bits(xref))
