"""Tile-level ops: BLAS-3 (gemm/syrk/trsm), LAPACK-like helpers and df64
arithmetic."""

from dla_tpu_torch.ops.blas import gemm, syrk, trsm
from dla_tpu_torch.ops.df64 import df64_matmul_nt, from_df64, to_df64
from dla_tpu_torch.ops.lapack_like import (
    geadd,
    lacpy,
    lange,
    lauum,
    plghe,
    plghe_tile,
    plgsy,
    plgsy_tile,
    potrf_unblocked,
    spd_gershgorin,
    trtri_lower,
)

__all__ = [
    "df64_matmul_nt", "from_df64", "geadd", "gemm", "lacpy", "lange", "lauum", "plghe",
    "plghe_tile", "plgsy", "plgsy_tile", "potrf_unblocked", "spd_gershgorin", "syrk", "to_df64",
    "trsm", "trtri_lower",
]
