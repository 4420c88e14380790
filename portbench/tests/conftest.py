"""Helpers for the benchmark's own tests: each cell of ``BENCHMARK.json``
cut to a size the CPU runs in a second, its configuration and traffic
otherwise as committed."""

from __future__ import annotations

import dataclasses

from portbench import spec

SMALL = {
    "spotrf_high_n61440": dict(n=256, nb=64, tb=64, kb=64, ib=32),
    "dpotrf_fp64_n24576": dict(n=256, nb=64, tb=64, kb=64, ib=32),
}
SMALL_SOLVE = dict(nrhs=[1, 4, 16], per_pass=2, sample_every=3)


def small_cell(name: str) -> spec.Cell:
    cell = spec.cell(spec.load_benchmark(), name)
    traffic = dict(cell.traffic)
    if traffic["loop"] == "closed":
        traffic.update(SMALL_SOLVE)
    return dataclasses.replace(cell, config=dict(cell.config, **SMALL[cell.config["name"]]),
                               traffic=traffic)
