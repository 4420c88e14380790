"""POTRI and batched POTRF — counterpart of ``dla_tpu/algos/potri.py``.

``potri`` computes A⁻¹ from the Cholesky factor (LAPACK ``dpotri``: A⁻¹ =
L⁻ᵀ·L⁻¹), and ``solve_inverse`` answers a block of right-hand sides with one
product against it: the serving trade of an O(N³) inverse once for
full-rate products per query, at a forward error of about κ(A)·eps.
``potrf_batched`` factors a batch of SPD matrices, one blocked factorization
per matrix.
"""

from __future__ import annotations

import torch

from dla_tpu_torch.algos.potrf import potrf_blocked
from dla_tpu_torch.algos.solve import _solve_lower_blocked
from dla_tpu_torch.ops import trsm
from dla_tpu_torch.ops.blas import _acc_dtype, _matmul


def potri(l: torch.Tensor, *, blocked: bool | None = None, ib: int = 1024) -> torch.Tensor:
    """Inverse of A = L·Lᵀ from its factor: A⁻¹ = L⁻ᵀ·L⁻¹, the full symmetric
    matrix. L⁻¹ is one triangular solve against the identity (``blocked``,
    default auto at n ≥ 2048: the block-inverse solve of
    :mod:`dla_tpu_torch.algos.solve` with ib×ib diagonal inverses), then one
    product L⁻ᵀ·L⁻¹ at the precision tier. Reads only tril(``l``)."""
    n = l.shape[-1]
    eye = torch.eye(n, dtype=l.dtype, device=l.device)
    if blocked is None:
        blocked = n >= 2048
    if blocked:
        linv = _solve_lower_blocked(l, eye, trans=False, ib=ib)
    else:
        linv = trsm(1.0, l, eye, side="L", uplo="L", transa=False)
    lh = linv.mT.conj() if l.is_complex() else linv.mT
    return _matmul(lh, linv, _acc_dtype(linv.dtype)).to(linv.dtype)


def solve_inverse(ainv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """X = A⁻¹·B as one product from a :func:`potri` inverse, at the precision
    tier; ``b`` is (n,) or (n, nrhs)."""
    vec = b.ndim == 1
    bb = b[:, None] if vec else b
    x = _matmul(ainv, bb.to(ainv.dtype), _acc_dtype(ainv.dtype)).to(ainv.dtype)
    return x[:, 0] if vec else x


def potrf_batched(a: torch.Tensor, *, nb: int = 64) -> torch.Tensor:
    """Factor a batch of SPD matrices (..., n, n): ``potrf_blocked(nb=nb)``
    on each matrix of the flattened batch. Returns the factors, strict upper
    triangles zero."""
    batch_shape, n = a.shape[:-2], a.shape[-1]
    flat = a.reshape(-1, n, n)
    out = torch.stack([potrf_blocked(m, nb=nb) for m in flat]) if len(flat) else flat.clone()
    return out.reshape(*batch_shape, n, n)
