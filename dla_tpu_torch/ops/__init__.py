"""Tile-level ops: BLAS-3 (gemm/syrk/trsm) and LAPACK-like helpers."""

from dla_tpu_torch.ops.blas import gemm, syrk, trsm
from dla_tpu_torch.ops.lapack_like import lange, plgsy, plgsy_tile

__all__ = ["gemm", "lange", "plgsy", "plgsy_tile", "syrk", "trsm"]
