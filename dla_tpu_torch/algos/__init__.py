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

__all__ = [
    "freivalds_packed",
    "pack_tri",
    "packed_len",
    "plgsy_packed",
    "potrf",
    "potrf_inplace",
    "potrf_packed",
    "unpack_tri",
]
