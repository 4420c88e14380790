"""dla_tpu_torch — the PyTorch/CUDA port of ``dla_tpu`` for NVIDIA Hopper.

Plain tensor code is torch; every Pallas kernel of the JAX package becomes a
hand-written Hopper kernel (CUDA C++ under ``kernels/csrc/``), with a plain
torch version beside it that runs on CPU tensors. The package imports torch
and never jax, so it never imports ``dla_tpu`` either; the tests hold it
against the JAX package on the same numpy inputs.

This slice covers the single-device POTRF main path: ``plgsy`` →
``potrf_inplace`` (panel in torch ops, trailing update in the kernel) →
``residual_potrf``. Importing the package switches TF32 off
(:func:`dla_tpu_torch.utils.precision.pin_ieee_fp32`).
"""

from dla_tpu_torch.utils.precision import pin_ieee_fp32

pin_ieee_fp32()

from dla_tpu_torch.algos import potrf, potrf_inplace  # noqa: E402
from dla_tpu_torch.ops import gemm, lange, plgsy, plgsy_tile, syrk, trsm  # noqa: E402
from dla_tpu_torch.validate import cholesky_invariants, residual_potrf  # noqa: E402

__all__ = [
    "cholesky_invariants",
    "gemm",
    "lange",
    "plgsy",
    "plgsy_tile",
    "potrf",
    "potrf_inplace",
    "residual_potrf",
    "syrk",
    "trsm",
]
