"""The benchmark's inputs, made on the device from ``--seed``.

The matrix of every cell is the symmetric matrix whose lower triangle is
that of U + n·I, U uniform on [-0.5, 0.5): strictly diagonally dominant,
so SPD, with a condition number near 3, as the reference's ``dplgsy`` with
bump n (``v6_test.c:46``). The program and the reference read its lower
triangle only; the upper triangle holds other draws of U.

Every seed gives the same sizes of work: a solve cell's right-hand-side
widths are the mix's fixed set, which the seed only orders; their values
are drawn on the card as each query is made (``entries/potrs.py``).
"""

from __future__ import annotations

import hashlib
import random

import torch


def subseed(seed: int, *parts) -> int:
    """A 63-bit seed for one purpose, from the run's seed and the purpose's
    name; any whole number serves as ``seed``."""
    h = hashlib.sha256(repr((int(seed),) + parts).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(device, seed: int, *parts) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, *parts))
    return g


def spd_dense(n: int, dtype: torch.dtype, device, seed: int) -> torch.Tensor:
    """The cell's (n, n) matrix, in one draw."""
    a = torch.rand((n, n), generator=generator(device, seed, "A"), dtype=dtype, device=device)
    a.sub_(0.5)
    a.diagonal().add_(n)
    return a


def column(a: torch.Tensor, nb: int, j: int, dtype: torch.dtype) -> torch.Tensor:
    """Rows j·nb … n of the matrix's tile column j, in ``dtype``: an
    (n − j·nb, nb) tensor on the matrix's device."""
    return a[j * nb :, j * nb : (j + 1) * nb].to(dtype, copy=True)


def query_order(traffic: dict, seed: int) -> list:
    """The widths of one pass of the query stream: each of the mix's
    ``nrhs`` ``per_pass`` times, in the seed's order. The stream repeats the
    pass, so every seed sends the same work."""
    widths = list(traffic["nrhs"]) * traffic["per_pass"]
    random.Random(subseed(seed, "order")).shuffle(widths)
    return widths
