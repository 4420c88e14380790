"""dla_tpu_torch — the PyTorch/CUDA port of ``dla_tpu`` for NVIDIA Hopper.

Plain tensor code is torch; every Pallas kernel of the JAX package becomes a
hand-written Hopper kernel (CUDA C++ under ``kernels/csrc/``), with a plain
torch version beside it that runs on CPU tensors. The package imports torch
and never jax, so it never imports ``dla_tpu`` either; the tests hold it
against the JAX package on the same numpy inputs.

Ported so far: the single-device POTRF formulations, ``plgsy`` →
``potrf`` (``mode="blocked"|"masked"|"shrink"|"inplace"``, with the panel
and trailing kernels on their ``"pallas"`` routes) → ``residual_potrf``,
and the packed-storage path, ``plgsy_packed`` →
``potrf_packed`` (the packed trailing update in a kernel) →
``freivalds_packed``, and the emulated-fp64 path, ``to_df64`` →
``potrf_df64`` (the df64 trailing update in a kernel) →
``residual_potrf_df64_blocked``, and its packed form, ``plgsy_packed`` →
``potrf_packed_df64`` (the packed df64 trailing update in a kernel) →
``freivalds_packed_df64``, with the df64 solves ``potrs_df64`` and
``potrs_packed_df64`` and the streaming df64 Freivalds gates
(``dla_tpu_torch.ops`` and ``dla_tpu_torch.algos`` export them, as the JAX
package's subpackages do).
Importing the package switches TF32 off
(:func:`dla_tpu_torch.utils.precision.pin_ieee_fp32`).
"""

from dla_tpu_torch.utils.precision import pin_ieee_fp32

pin_ieee_fp32()

from dla_tpu_torch.algos import (  # noqa: E402
    freivalds_packed,
    pack_tri,
    plgsy_packed,
    potrf,
    potrf_blocked,
    potrf_inplace,
    potrf_masked,
    potrf_packed,
    potrf_shrink,
    unpack_tri,
)
from dla_tpu_torch.ops import (  # noqa: E402
    gemm,
    lange,
    plgsy,
    plgsy_tile,
    potrf_unblocked,
    syrk,
    trsm,
)
from dla_tpu_torch.validate import cholesky_invariants, residual_potrf  # noqa: E402

__all__ = [
    "cholesky_invariants",
    "freivalds_packed",
    "gemm",
    "lange",
    "pack_tri",
    "plgsy",
    "plgsy_packed",
    "plgsy_tile",
    "potrf",
    "potrf_blocked",
    "potrf_inplace",
    "potrf_masked",
    "potrf_packed",
    "potrf_shrink",
    "potrf_unblocked",
    "residual_potrf",
    "syrk",
    "trsm",
    "unpack_tri",
]
