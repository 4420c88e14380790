"""Residual gates and invariants (``potrf_checked`` lives in
:mod:`dla_tpu_torch.validate.checked`, as in the JAX package)."""

from dla_tpu_torch.validate.residual import (
    PASS_THRESHOLD,
    cholesky_invariants,
    freivalds_device,
    residual_posv,
    residual_potrf,
)

__all__ = ["PASS_THRESHOLD", "cholesky_invariants", "freivalds_device", "residual_posv",
           "residual_potrf"]
