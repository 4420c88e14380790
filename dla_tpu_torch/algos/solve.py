"""Solve path — counterpart of ``dla_tpu/algos/solve.py``.

Ported so far: :func:`_solve_lower_blocked`, the block-inverse triangular
solve that the packed serving functions use for wide diagonal blocks. The
rest of the module (``potrs``, ``posv``, the refined solves) is a later slice
(``ROADMAP.md``).
"""

from __future__ import annotations

import torch

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
