"""Residual gates and invariants."""

from dla_tpu_torch.validate.residual import PASS_THRESHOLD, cholesky_invariants, residual_potrf

__all__ = ["PASS_THRESHOLD", "cholesky_invariants", "residual_potrf"]
