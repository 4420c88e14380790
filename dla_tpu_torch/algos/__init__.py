"""Factorization algorithms."""

from dla_tpu_torch.algos.packed import (
    freivalds_packed,
    pack_tri,
    packed_len,
    plgsy_packed,
    potrf_packed,
    unpack_tri,
)
from dla_tpu_torch.algos.potrf import (
    potrf,
    potrf_blocked,
    potrf_inplace,
    potrf_masked,
    potrf_shrink,
)
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
    "potrf_blocked",
    "potrf_df64",
    "potrf_inplace",
    "potrf_masked",
    "potrf_packed",
    "potrf_shrink",
    "residual_potrf_df64",
    "residual_potrf_df64_blocked",
    "unpack_tri",
]
