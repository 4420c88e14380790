"""dla_tpu_torch — the PyTorch/CUDA port of ``dla_tpu`` for NVIDIA Hopper.

Plain tensor code is torch; every Pallas kernel of the JAX package becomes a
hand-written Hopper kernel (CUDA C++ under ``kernels/csrc/``), with a plain
torch version beside it that runs on CPU tensors. The package imports torch
and never jax, so it never imports ``dla_tpu`` either; the tests hold it
against the JAX package on the same numpy inputs.

Ported so far: the single-device POTRF formulations, ``plgsy`` →
``potrf`` (``mode="blocked"|"masked"|"shrink"|"inplace"``, with the panel
and trailing kernels on their ``"pallas"`` routes) → ``residual_potrf``, or,
where A and L do not fit the device together, the matrix-free
``freivalds_device``; the packed-storage path, ``plgsy_packed`` →
``potrf_packed`` (the packed trailing update in a kernel) →
``freivalds_packed``, with ``potrs_packed`` and the packed serving path
(``potri_packed``, ``solve_inverse_packed``, ``residual_posv_streamed``);
the emulated-fp64 path,
``to_df64`` → ``potrf_df64`` (the df64 trailing update in a kernel) →
``residual_potrf_df64_blocked``, and its packed form, ``plgsy_packed`` →
``potrf_packed_df64`` (the packed df64 trailing update in a kernel) →
``freivalds_packed_df64``, with the df64 solves ``potrs_df64`` and
``potrs_packed_df64`` and the streaming df64 Freivalds gates; the four task
kernels of the reference's tile DAG, ``potrf_tile``, ``trsm_tile``,
``syrk_tile`` and ``gemm_tile`` (``dla_tpu_torch.kernels.tiles``), with the
tile descriptor ``TileLayout`` and the DAG's task counts
(``dla_tpu_torch.cli.session.dag_counts``); the dense solve and serving path
after the factor, ``potrs``, ``posv``, ``posv_refined``,
``posv_refined_host``, ``potri``, ``solve_inverse`` and ``lauum``, with
``residual_posv``; complex (c/z) inputs on every route but the hand
kernels' (``plghe``), ``potrf_checked``, out of core and the block-cyclic
plane on a member mesh; and the entry points: the driver (``python -m
dla_tpu_torch.cli.potrf_driver``, the JAX driver's flags), the session, the
out-of-core driver, the LAPACK oracle, the tiered bench (``python -m
dla_tpu_torch.bench.bench``) and the sweep harness with its plots; and the
finance-model package, ``dla_tpu_torch.models`` (its CLI ``python -m
dla_tpu_torch.models.cli``). The top level exports the names
the JAX package's top level does; the rest is exported by
``dla_tpu_torch.ops``, ``dla_tpu_torch.algos`` and ``dla_tpu_torch.validate``,
as by the JAX package's subpackages.
Importing the package switches TF32 off
(:func:`dla_tpu_torch.utils.precision.pin_ieee_fp32`).
"""

__version__ = "0.1.0"

from dla_tpu_torch.utils.precision import pin_ieee_fp32  # noqa: E402

pin_ieee_fp32()

from dla_tpu_torch.algos import (  # noqa: E402
    pack_tri,
    posv,
    potrf,
    potrf_blocked,
    potrf_masked,
    potrf_packed,
    potri,
    potri_packed,
    potrs,
    potrs_packed,
    solve_inverse,
    solve_inverse_packed,
    unpack_tri,
)
from dla_tpu_torch.ops import (  # noqa: E402
    geadd,
    gemm,
    lacpy,
    lange,
    lauum,
    plghe,
    plghe_tile,
    plgsy,
    plgsy_tile,
    potrf_unblocked,
    spd_gershgorin,
    syrk,
    trsm,
)
from dla_tpu_torch.tiles import TileLayout  # noqa: E402
from dla_tpu_torch.validate import cholesky_invariants, residual_potrf  # noqa: E402

__all__ = [
    "TileLayout",
    "cholesky_invariants",
    "geadd",
    "gemm",
    "lacpy",
    "lange",
    "lauum",
    "pack_tri",
    "plghe",
    "plghe_tile",
    "plgsy",
    "plgsy_tile",
    "posv",
    "potrf",
    "potrf_blocked",
    "potrf_masked",
    "potrf_packed",
    "potrf_unblocked",
    "potri",
    "potri_packed",
    "potrs",
    "potrs_packed",
    "residual_potrf",
    "solve_inverse",
    "solve_inverse_packed",
    "spd_gershgorin",
    "syrk",
    "trsm",
    "unpack_tri",
]
