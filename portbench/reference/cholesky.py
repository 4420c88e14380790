"""Right-looking blocked Cholesky on column panels, and its solves.

Panel j holds rows j·nb … n of the matrix's tile column j, an (n − j·nb, nb)
tensor. Only the lower triangle is read. Every product is a plain ``torch``
call in the panels' dtype (float64, where TF32 never applies).
"""

from __future__ import annotations

import torch


def factor(panels, nb: int) -> None:
    """Factor the panels in place: panel j ends as rows j·nb … n of L's tile
    column j (its diagonal tile lower)."""
    nt = len(panels)
    for j in range(nt):
        pj = panels[j]
        ljj, _ = torch.linalg.cholesky_ex(pj[:nb])
        pj[:nb] = ljj
        if j == nt - 1:
            break
        pj[nb:] = torch.linalg.solve_triangular(ljj.mT, pj[nb:], upper=True, left=False)
        below = pj[nb:]
        for k in range(j + 1, nt):
            r0 = (k - j - 1) * nb
            panels[k].addmm_(below[r0:], below[r0 : r0 + nb].mT, alpha=-1.0)


def solve(panels, b: torch.Tensor, nb: int) -> torch.Tensor:
    """X with L·Lᵀ·X = B, from factored panels."""
    y = b.to(panels[0].dtype).clone()
    nt = len(panels)
    for j in range(nt):
        pj = panels[j]
        rows = slice(j * nb, (j + 1) * nb)
        y[rows] = torch.linalg.solve_triangular(pj[:nb], y[rows], upper=False)
        if j < nt - 1:
            y[(j + 1) * nb :] -= pj[nb:] @ y[rows]
    for j in reversed(range(nt)):
        pj = panels[j]
        rows = slice(j * nb, (j + 1) * nb)
        if j < nt - 1:
            y[rows] -= pj[nb:].mT @ y[(j + 1) * nb :]
        y[rows] = torch.linalg.solve_triangular(pj[:nb].mT, y[rows], upper=True)
    return y
