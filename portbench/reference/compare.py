"""The comparisons that decide ``correct``.

``factor_err``: the program's factor against the reference's, over the
whole lower triangle, each part at its own scale: the largest error on the
diagonal over the largest reference diagonal element, and the largest error
strictly below it over the largest reference element there. The matrix is
diagonally dominant, so L's diagonal is some √n times larger than the rest:
one scale for both would hide every error below the diagonal.

``solve_err``: the largest over the compared queries of max|X − X_ref| over
max|X_ref|.

A NaN anywhere makes the number NaN, which no limit passes.
"""

from __future__ import annotations

import torch


def factor_parts(prog: torch.Tensor, ref: torch.Tensor, nb: int) -> torch.Tensor:
    """For one panel (rows j·nb … n of tile column j, the program's in
    float64 beside the reference's): max |error| and max |ref| on the
    diagonal, then strictly below it, as a 4-vector on the panel's device."""
    e = (prog - ref).abs()
    r = ref.abs()
    top_e, top_r = e[:nb], r[:nb]
    below_e = torch.tril(top_e, -1).amax()
    below_r = torch.tril(top_r, -1).amax()
    if e.shape[0] > nb:
        below_e = torch.maximum(below_e, e[nb:].amax())
        below_r = torch.maximum(below_r, r[nb:].amax())
    return torch.stack([top_e.diagonal().amax(), top_r.diagonal().amax(), below_e, below_r])


def factor_err(parts) -> float:
    """``factor_err`` from the panels' :func:`factor_parts`."""
    m = torch.stack([p.cpu() for p in parts]).amax(dim=0)
    return float(torch.maximum(m[0] / m[1], m[2] / m[3]))


def solve_err(x: torch.Tensor, x_ref: torch.Tensor) -> float:
    x = x.to(x_ref.dtype)
    return float((x - x_ref).abs().amax() / x_ref.abs().amax())
