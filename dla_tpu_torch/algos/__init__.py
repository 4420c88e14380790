"""Factorization algorithms."""

from dla_tpu_torch.algos.packed import (
    freivalds_packed,
    pack_tri,
    packed_len,
    plgsy_packed,
    potrf_packed,
    unpack_tri,
)
from dla_tpu_torch.algos.potrf import potrf, potrf_inplace
from dla_tpu_torch.algos.potrf_df64 import (
    potrf_df64,
    residual_potrf_df64,
    residual_potrf_df64_blocked,
)

__all__ = [
    "freivalds_packed",
    "pack_tri",
    "packed_len",
    "plgsy_packed",
    "potrf",
    "potrf_df64",
    "potrf_inplace",
    "potrf_packed",
    "residual_potrf_df64",
    "residual_potrf_df64_blocked",
    "unpack_tri",
]
