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

Complex (c/z) products are IEEE at every tier: the tiers' bf16 rounding
applies to real fp32 operands only. That is the JAX package's arithmetic on
the CPU, which runs every complex dot in full precision whatever the tier.
``DLA_TPU_C3M=1`` routes the trailing-update form A·Bᵀ/A·Bᴴ through three
real products instead of four (:func:`_gemm3m_nt`, off by default, as in the
reference); its real products are IEEE too.
"""

from __future__ import annotations

import os

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


def _c3m_enabled() -> bool:
    """The 3M complex product is opt-in (``DLA_TPU_C3M=1``), as in the
    reference (``dla_tpu/ops/blas.py:36``)."""
    return os.environ.get("DLA_TPU_C3M", "0") == "1"


def _gemm3m_nt(a: torch.Tensor, b: torch.Tensor, conjb: bool) -> torch.Tensor:
    """Complex A·Bᵀ (or A·Bᴴ) by Karatsuba's three real products instead of
    the four of a complex product (``dla_tpu/ops/blas.py:48``):

      T1 = Xa·Xbᵀ, T2 = Ya·Ybᵀ
      A·Bᴴ: T3 = (Xa+Ya)·(Xb−Yb)ᵀ → re = T1+T2, im = T3 − T1 + T2
      A·Bᵀ: T3 = (Xa+Ya)·(Xb+Yb)ᵀ → re = T1−T2, im = T3 − T1 − T2

    The 3M error is bounded against the norm of the whole product, not per
    component; every c/z gate here is norm-relative. The real products are
    IEEE fp32 (fp64 for complex128) at every tier."""
    racc = torch.float64 if a.dtype == torch.complex128 else torch.float32
    xa, ya = a.real.to(racc), a.imag.to(racc)
    xb, yb = b.real.to(racc), b.imag.to(racc)
    t1 = xa @ xb.mT
    t2 = ya @ yb.mT
    if conjb:
        t3 = (xa + ya) @ (xb - yb).mT
        re, im = t1 + t2, t3 - t1 + t2
    else:
        t3 = (xa + ya) @ (xb + yb).mT
        re, im = t1 - t2, t3 - t1 - t2
    return torch.complex(re, im)


def gemm(alpha, a, b, beta, c, *, transa: bool = False, transb: bool = False,
         conja: bool = False, conjb: bool = False) -> torch.Tensor:
    """C ← alpha·op(A)·op(B) + beta·C, returned as a new tensor of C's type.
    ``conja``/``conjb`` conjugate the operand (with trans: the Hermitian
    ``A·Aᴴ`` updates of c/z POTRF). Complex ``A·Bᵀ/ᴴ`` (the trailing-update
    form) goes through :func:`_gemm3m_nt` when ``DLA_TPU_C3M=1``."""
    acc = _acc_dtype(c.dtype)
    if (a.is_complex() and b.is_complex() and not transa and not conja and transb
            and _c3m_enabled()):
        prod = _gemm3m_nt(a, b, conjb).to(acc)
        return (alpha * prod + beta * c.to(acc)).to(c.dtype)
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
