"""LAPACK-like helpers — counterpart of ``dla_tpu/ops/lapack_like.py``.

- ``plgsy_tile`` / ``plgsy`` ↔ ``CHAMELEON_dplgsy_Tile(bump, uplo, desc,
  seed)`` (``v6_test.c:46``): the seeded, tile-local deterministic symmetric
  generator. It matches the JAX package bit for bit, so both packages factor
  the same matrix from the same seed.
- ``lange`` ↔ ``CHAMELEON_dlange_Tile`` (``v6_test.c:72,84``).
- ``lauum`` ↔ ``CHAMELEON_dlauum_Tile`` (``v6_test.c:76-78``).
- ``potrf_unblocked``: the rank-1 column loop behind
  ``diag_factor="unblocked"``.
- ``trtri_lower``: the inverse of a lower-triangular tile by forward
  substitution.

The generators build on the card unless the caller asks for another device
(``device="cpu"``); without a card the default call raises.

The generator's murmur3 hash works on uint32 with wraparound. Torch has no
uint32 right shift on the CPU, so the hash runs in int64 and masks the low
32 bits after every multiply; int64 multiplication wraps, which keeps those
low bits exact.
"""

from __future__ import annotations

import numpy as np
import torch

_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_C1 = 0x9E3779B9  # golden-ratio increment (splitmix)
_C2 = 0x7F4A7C15
_MASK = 0xFFFFFFFF

# plgsy generates in row slabs of about this many elements, so the int64
# hash temporaries stay small next to the matrix itself
_SLAB_ELEMS = 1 << 25


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = (x * _M1) & _MASK
    x = x ^ (x >> 13)
    x = (x * _M2) & _MASK
    return x ^ (x >> 16)


def _pair_uniform(seed: int, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Deterministic uniform(-0.5, 0.5) fp32 value for the *unordered* pair
    (i, j): the matrix is exactly symmetric by construction."""
    lo = torch.minimum(i, j)
    hi = torch.maximum(i, j)
    h = _mix32(((hi * _C2) & _MASK) ^ (seed & _MASK))
    h = _mix32(((lo * _C1) & _MASK) ^ h)
    # 24 high bits -> float32 uniform in [0, 1): exact in fp32
    u = (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return u - 0.5


def plgsy_tile(
    seed: int,
    i0: int,
    j0: int,
    mb: int,
    nb: int,
    *,
    bump: float = 0.0,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> torch.Tensor:
    """The (mb × nb) tile of the global seeded symmetric matrix whose
    top-left element is global (i0, j0); ``bump`` is added on the global
    diagonal. The values are computed in fp32 and then cast, so an fp64
    matrix holds fp32-exact values plus the bump."""
    rows = (i0 + torch.arange(mb, dtype=torch.int64, device=device))[:, None]
    cols = (j0 + torch.arange(nb, dtype=torch.int64, device=device))[None, :]
    vals = _pair_uniform(int(seed), rows, cols).to(dtype)
    if bump:
        vals = vals + torch.where(
            rows == cols,
            torch.tensor(bump, dtype=dtype, device=device),
            torch.tensor(0, dtype=dtype, device=device),
        )
    return vals


def plgsy(
    n: int,
    *,
    bump: float | None = None,
    seed: int = 51,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> torch.Tensor:
    """Full n×n seeded symmetric matrix with diagonal bump (default bump=n,
    as ``dplgsy_Tile((double)N, ChamLower, descA, seed)`` at ``v6_test.c:46``,
    which makes it SPD by diagonal dominance). Generated in row slabs."""
    if bump is None:
        bump = float(n)
    out = torch.empty((n, n), dtype=dtype, device=device)
    slab = max(1, _SLAB_ELEMS // max(n, 1))
    for r0 in range(0, n, slab):
        rows = min(slab, n - r0)
        out[r0 : r0 + rows] = plgsy_tile(
            seed, r0, 0, rows, n, bump=bump, dtype=dtype, device=device
        )
    return out


def lange(norm: str, a: torch.Tensor) -> torch.Tensor:
    """Matrix norm à la ``dlange``: 'M' (max abs), '1' (max col sum),
    'I' (max row sum), 'F' (Frobenius). Used by the residual contract
    ``||A − LL^T||_inf / ||A||_inf`` (``v6_test.c:72-86``)."""
    norm = norm.upper()
    aa = torch.abs(a)
    if norm == "M":
        return torch.max(aa)
    if norm == "1" or norm == "O":
        return torch.max(torch.sum(aa, dim=0))
    if norm == "I":
        return torch.max(torch.sum(aa, dim=1))
    if norm == "F":
        return torch.sqrt(torch.sum(torch.square(a)))
    raise ValueError(f"unknown norm {norm!r}")


def lauum(uplo: str, a: torch.Tensor) -> torch.Tensor:
    """``dlauum`` with LAPACK semantics (``dla_tpu/ops/lapack_like.py:210``):
    lower → Lᵀ·L, upper → U·Uᵀ, from the relevant triangle of ``a`` only; the
    product in ``a``'s dtype (IEEE fp32 for fp32: TF32 is pinned off)."""
    u = uplo.upper()
    if u in ("L", "LOWER"):
        l = torch.tril(a)
        return l.mT @ l
    if u in ("U", "UPPER"):
        r = torch.triu(a)
        return r @ r.mT
    raise ValueError(f"unknown uplo {uplo!r}")


def trtri_lower(l: torch.Tensor) -> torch.Tensor:
    """Inverse of a lower-triangular tile by forward substitution
    (``dla_tpu/ops/lapack_like.py:263``): n steps, each dividing row j of the
    running inverse by the pivot ``l[j, j]`` and taking the rank-1 update of
    column j below the diagonal from the rows beneath; returns tril of the
    result. Only the lower triangle of ``l`` is read."""
    n = l.shape[-1]
    x = torch.eye(n, dtype=l.dtype, device=l.device)
    for j in range(n):
        xrow = x[j] / l[j, j]
        x[j] = xrow
        x[j + 1 :] -= torch.outer(l[j + 1 :, j], xrow)
    return torch.tril(x)


def potrf_unblocked(a: torch.Tensor) -> torch.Tensor:
    """Unblocked lower Cholesky of one tile by n rank-1 updates, one per
    column (``dla_tpu/ops/lapack_like.py:236``, the reference's scalar
    diagonal-block loop, ``lapack_dpotrf_remix_c.c:24-36``). Only the lower
    triangle is read; the strict upper triangle of the result is zero. The
    update is A − l·lᴴ, so complex (Hermitian) tiles factor too."""
    n = a.shape[-1]
    acc = a.clone()
    for j in range(n):
        piv = _sqrt_rn(acc[j, j])
        acc[j, j] = piv
        col = acc[j + 1 :, j] / piv
        acc[j + 1 :, j] = col
        acc[j + 1 :, j + 1 :] -= torch.outer(col, col.conj())
    return torch.tril(acc)


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded sqrt. Torch's CPU sqrt can miss by an ulp, in fp32
    and in fp64 alike, so an fp32 or fp64 tensor on the CPU takes its root
    from ``numpy.sqrt`` (the hardware's correctly rounded one). An fp32 root
    is numpy's fp64 root rounded to fp32, which rounds correctly too (53 ≥
    2·24 + 2 bits). On a CUDA device ``torch.sqrt`` is correctly rounded."""
    if x.device.type != "cpu" or x.dtype not in (torch.float32, torch.float64):
        return torch.sqrt(x)
    root = np.asarray(np.sqrt(x.detach().numpy().astype(np.float64)))
    return torch.from_numpy(root.astype(np.float32 if x.dtype == torch.float32 else np.float64))
