"""Sharded serving: the explicit-inverse apply on a mesh of members —
counterpart of ``dla_tpu/parallel/serving.py``.

A⁻¹ (from :func:`dla_tpu_torch.algos.potri`, computed once) is sharded by
rows over a flat mesh, the (n, nrhs) query block is replicated, each member
computes its (n/P, nrhs) slab, and the slabs are all-gathered (concatenated
here) into the replicated answer: one collective of n·nrhs elements per
query block.

:func:`project_serving` models when a mesh of cards pays, in the same style
as :func:`dla_tpu_torch.parallel.model.project`: compute calibrated by the
single-card serving rates measured on one H100 (``SERVING_RATE_GFLOPS``),
comm from the all-gather volume (:func:`serving_comm_elems`) at the chip's
link figures.
"""

from __future__ import annotations

import math

import torch

from dla_tpu_torch.algos.potri import solve_inverse
from dla_tpu_torch.parallel import member_comm as comm
from dla_tpu_torch.parallel import model
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


# Measured single-card inverse-path serving rates (GF/s at the LAPACK
# 2·N²·NRHS convention): solve_inverse (one product at the `high` tier) on a
# resident fp32 A⁻¹, N=16384, mean of back-to-back calls by CUDA events;
# measured by `python -m dla_tpu_torch.bench.calibrate_model --only serving` on
# an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md's calibration table lists the
# run). Memory-stream-bound at nrhs=1 (0.351 ms for A⁻¹'s 1 GiB);
# from 128 on the product's rate: `high` is IEEE fp32 here, one SGEMM.
# Linear interpolation in log2(nrhs), saturating at the ends.
SERVING_RATE_GFLOPS = {1: 1531.6, 128: 51585.4, 1024: 50629.8}


def serving_rate(nrhs: int, chip: str = "h100") -> float:
    """Measured-curve serving rate (GF/s) at RHS width nrhs."""
    pts = sorted(SERVING_RATE_GFLOPS.items())
    scale = model.CHIPS[chip].tflops["high"] / model.CHIPS[model.BASE_CHIP].tflops["high"]
    if nrhs <= pts[0][0]:
        r = pts[0][1]
    elif nrhs >= pts[-1][0]:
        r = pts[-1][1]
    else:
        lx = math.log2(nrhs)
        for (n0, r0), (n1, r1) in zip(pts, pts[1:]):
            if n0 <= nrhs <= n1:
                t = (lx - math.log2(n0)) / (math.log2(n1) - math.log2(n0))
                r = r0 + (r1 - r0) * t
                break
    return r * scale


def project_serving(
    n: int,
    nrhs: int,
    p: int,
    *,
    chip: str = "h100",
    itemsize: int = 4,
) -> dict:
    """Projected per-query latency / throughput of the sharded inverse
    apply on a p-card mesh vs one card.

    The single-card time comes from the *measured* serving-rate curve; it
    is decomposed into a **scalable** part — max(A⁻¹ memory stream,
    tensor-core flop time at the `high` ceiling), both of which
    row-sharding divides exactly p ways — and a **fixed** part (launch,
    B/X traffic, sub-ceiling GEMM inefficiency) that is conservatively NOT
    divided. Comm is the all-gather volume at the chip's link figures.
    Row-sharding also divides A⁻¹'s n²·itemsize across cards — the mesh
    unlocks sizes where one card cannot even hold A⁻¹.
    """
    spec = model.CHIPS[chip]
    rate = serving_rate(nrhs, chip) * 1e9
    bw = spec.ici_gbps * 1e9 * spec.link_efficiency
    lat = spec.latency_us * 1e-6
    flops = 2.0 * n * n * nrhs
    t_single = flops / rate
    # scalable: the larger of streaming A⁻¹ once and running the GEMM at
    # the tier's ceiling; fixed: everything the measurement carries beyond
    # that (never negative — wide blocks can measure at ~the ceiling, where
    # the stream is hidden under the product time)
    t_stream = n * n * itemsize / (spec.hbm_gbps * 1e9)
    t_mxu = flops / (spec.tflops["high"] * 1e12)
    t_scalable = max(t_stream, t_mxu)
    t_fixed = max(0.0, t_single - t_scalable)
    t_comm = serving_comm_elems(n, nrhs, p) * itemsize / bw + lat
    t_dist = t_scalable / p + t_fixed + t_comm
    ainv_gib = n * n * itemsize / 2**30
    return {
        "n": n, "nrhs": nrhs, "p": p, "chip": chip,
        "t_single_s": t_single, "t_dist_s": t_dist,
        "t_comm_s": t_comm,
        "speedup": t_single / t_dist,
        "efficiency": t_single / t_dist / p,
        "queries_per_s": 1.0 / t_dist,
        "cols_per_s": nrhs / t_dist,
        "comm_fraction": t_comm / t_dist,
        "ainv_gib": ainv_gib,
        "single_chip_holds_ainv": ainv_gib <= spec.hbm_gib,
        "mesh_holds_ainv": ainv_gib / p <= spec.hbm_gib,
    }
