"""BLAS-3 tile ops in torch — counterpart of ``dla_tpu/ops/blas.py``.

The same calling shapes as the reference's task kernels
(``worker_distrib.cpp:323/:416/:511``):

- GEMM:  C ← alpha·op(A)·op(B) + beta·C
- SYRK:  C ← alpha·op(A)·op(A)^T + beta·C on one triangle
- TRSM:  B ← alpha·B·inv(op(A)) (side='R') or alpha·inv(op(A))·B (side='L')

Accumulation is pinned as in the reference: fp32 for bf16/fp16 operands,
the operand type otherwise. The fp32 product follows the precision tier
(:mod:`dla_tpu_torch.utils.precision`): ``default`` rounds the operands to
bf16 and accumulates in fp32; ``high`` and ``highest`` are IEEE fp32.
The opt-in 3M complex GEMM of the reference (``blas.py:48``) is not ported.
"""

from __future__ import annotations

import torch

from dla_tpu_torch.utils.precision import tier


def _op(a: torch.Tensor, trans: bool, conj: bool) -> torch.Tensor:
    a = a.mT if trans else a
    return a.conj() if conj else a


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def _matmul(a: torch.Tensor, b: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """``a @ b`` accumulated in ``acc`` at the active precision tier."""
    if acc == torch.float32 and tier() == "default":
        a = a.to(torch.bfloat16)
        b = b.to(torch.bfloat16)
    return torch.matmul(a.to(acc), b.to(acc))


def gemm(alpha, a, b, beta, c, *, transa: bool = False, transb: bool = False,
         conja: bool = False, conjb: bool = False) -> torch.Tensor:
    """C ← alpha·op(A)·op(B) + beta·C, returned as a new tensor of C's type.
    ``conja``/``conjb`` conjugate the operand (with trans: the Hermitian
    ``A·Aᴴ`` updates of c/z POTRF)."""
    acc = _acc_dtype(c.dtype)
    prod = _matmul(_op(a, transa, conja), _op(b, transb, conjb), acc)
    return (alpha * prod + beta * c.to(acc)).to(c.dtype)


def syrk(alpha, a, beta, c, *, uplo: str = "L", trans: bool = False) -> torch.Tensor:
    """C ← alpha·op(A)·op(A)^T + beta·C on the ``uplo`` triangle; the other
    triangle passes through from C (BLAS dsyrk semantics)."""
    acc = _acc_dtype(c.dtype)
    opa = _op(a, trans, False)
    full = (alpha * _matmul(opa, opa.mT, acc) + beta * c.to(acc)).to(c.dtype)
    mask = torch.ones(c.shape[-2:], dtype=torch.bool, device=c.device)
    mask = torch.tril(mask) if uplo.upper().startswith("L") else torch.triu(mask)
    return torch.where(mask, full, c)


def trsm(alpha, a, b, *, side: str = "R", uplo: str = "L", transa: bool = True,
         unit_diag: bool = False, conja: bool = False) -> torch.Tensor:
    """Triangular solve: alpha·B·inv(op(A)) (side='R') or alpha·inv(op(A))·B
    (side='L'), reading only the ``uplo`` triangle of A. Defaults match the
    reference's panel solve ``dtrsm_Tile(Right, Lower, Trans, NonUnit)``
    (``worker_distrib.cpp:323``)."""
    left = side.upper().startswith("L")
    lower = uplo.upper().startswith("L")
    # op(A) = Aᵀ of a lower A is upper
    upper = lower if transa else not lower
    x = torch.linalg.solve_triangular(
        _op(a, transa, conja), b, upper=upper, left=left, unitriangular=unit_diag
    )
    if alpha != 1:
        x = alpha * x
    return x
