"""Sharded serving: the explicit-inverse apply on a mesh of members —
counterpart of ``dla_tpu/parallel/serving.py``.

A⁻¹ (from :func:`dla_tpu_torch.algos.potri`, computed once) is sharded by
rows over a flat mesh, the (n, nrhs) query block is replicated, each member
computes its (n/P, nrhs) slab, and the slabs are all-gathered (concatenated
here) into the replicated answer: one collective of n·nrhs elements per
query block.

The JAX module's scaling model (``serving_rate``, ``project_serving`` and
their measured ``SERVING_RATE_GFLOPS``) holds TPU figures and is not
ported; :func:`serving_comm_elems`, the all-gather's volume, is.
"""

from __future__ import annotations

import torch

from dla_tpu_torch.algos.potri import solve_inverse
from dla_tpu_torch.parallel import member_comm as comm
from dla_tpu_torch.parallel.column_cyclic import FlatMesh, _tensor, make_flat_mesh


def make_serving_mesh(p: int, *, device="cuda") -> FlatMesh:
    """A flat mesh of p members with axis 'd' (serving shards one way, by
    rows), on the card unless the caller names another device."""
    return make_flat_mesh(p, device=device)


def sharded_apply(mesh: FlatMesh):
    """The apply for ``mesh``: (A⁻¹'s row blocks, one per member; replicated
    B) → replicated X, each member's product at the precision tier. A mesh
    across processes raises ``NotImplementedError``."""
    if mesh.spans_processes:
        raise NotImplementedError("sharded_apply: a mesh across processes is not supported")

    def apply(ainv_rows, b: torch.Tensor) -> torch.Tensor:
        rows = list(ainv_rows)
        if len(rows) != mesh.size:
            raise ValueError(f"need {mesh.size} row blocks, got {len(rows)}")
        return comm.all_gather_tiled([solve_inverse(a, b) for a in rows])

    return apply


def solve_inverse_sharded(ainv, b, mesh: FlatMesh) -> torch.Tensor:
    """X = A⁻¹·B with A⁻¹ (a tensor or numpy array) split by rows over
    ``mesh`` and B (n, nrhs) replicated; returns the replicated answer on the
    members' device. On one device the row blocks are views of ``ainv``."""
    ainv, b = _tensor(ainv), _tensor(b)
    n, p = ainv.shape[-1], mesh.size
    if n % p:
        raise ValueError(f"n={n} not divisible by mesh size {p}")
    rows = [blk.to(mesh.devices[d]) for d, blk in enumerate(ainv.split(n // p))]
    return sharded_apply(mesh)(rows, b.to(mesh.devices[0]))


def serving_comm_elems(n: int, nrhs: int, p: int) -> int:
    """Per-query all-gather wire volume in elements: each device sends its
    (n/p, nrhs) slab to the other p-1 — (p-1)/p·n·nrhs on the busiest
    link direction (ring all-gather)."""
    return (p - 1) * n // p * nrhs
