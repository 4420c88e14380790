"""Factorization algorithms."""

from dla_tpu_torch.algos.potrf import potrf, potrf_inplace

__all__ = ["potrf", "potrf_inplace"]
