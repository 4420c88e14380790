"""Factorization algorithms."""

from dla_tpu_torch.algos.packed import (
    freivalds_packed,
    pack_tri,
    packed_len,
    plgsy_packed,
    potrf_packed,
    potrs_packed,
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
    freivalds_potrf_df64,
    potrf_df64,
    potrf_packed_df64,
    potrf_packed_df64_split,
    potrs_df64,
    potrs_packed_df64,
    residual_potrf_df64,
    residual_potrf_df64_blocked,
    trmm_packed_df64,
)

__all__ = [
    "freivalds_packed",
    "freivalds_potrf_df64",
    "pack_tri",
    "packed_len",
    "plgsy_packed",
    "potrf",
    "potrf_blocked",
    "potrf_df64",
    "potrf_inplace",
    "potrf_masked",
    "potrf_packed",
    "potrf_packed_df64",
    "potrf_packed_df64_split",
    "potrf_shrink",
    "potrs_df64",
    "potrs_packed",
    "potrs_packed_df64",
    "residual_potrf_df64",
    "residual_potrf_df64_blocked",
    "trmm_packed_df64",
    "unpack_tri",
]
