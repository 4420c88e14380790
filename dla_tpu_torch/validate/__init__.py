"""Residual gates and invariants."""

from dla_tpu_torch.validate.residual import (
    PASS_THRESHOLD,
    cholesky_invariants,
    freivalds_device,
    residual_potrf,
)

__all__ = ["PASS_THRESHOLD", "cholesky_invariants", "freivalds_device", "residual_potrf"]
