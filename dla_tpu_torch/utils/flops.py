"""FLOP accounting for the tile kernels and whole factorizations.

A copy of ``dla_tpu/utils/flops.py``: it is framework-neutral, but
importing anything under ``dla_tpu`` imports jax, which the port never does.

The contract numbers mirror the reference's accounting where it is correct
and fix it where it is not:

- whole POTRF: GFLOP/s = (1/3)·N³ / t, no lower-order terms
  (``v6_test.c:60`` — kept bit-identical so CSVs are comparable).
- per-tile counts (``worker_distrib.cpp:247,332,425,519``): POTRF (1/3)B³,
  SYRK B³, GEMM 2B³ are standard; the reference's TRSM count of 0.5·B³ is
  half the standard B³ (SURVEY Appendix A) — corrected here.
"""

from __future__ import annotations


def potrf_flops(n: int) -> float:
    """Factorization model count, matching the reference's metric."""
    return n**3 / 3.0


def potrf_tile_flops(b: int) -> float:
    return b**3 / 3.0


def trsm_tile_flops(b: int) -> float:
    """Standard TRSM count B³ (the reference logged 0.5·B³ — a bug we do
    not reproduce)."""
    return float(b**3)


def syrk_tile_flops(b: int) -> float:
    return float(b**3)


def gemm_tile_flops(b: int) -> float:
    return 2.0 * b**3


def gflops(flops: float, seconds: float) -> float:
    return flops / seconds / 1e9
