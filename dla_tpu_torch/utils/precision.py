"""Matmul precision policy — counterpart of ``dla_tpu/utils/precision.py``.

The tier names, the ``DLA_TPU_MATMUL_PRECISION`` environment variable and
:func:`override` are the reference's, and so is their meaning:

- ``default`` (alias ``fastest``) — one bf16 pass: operands rounded to bf16,
  products accumulated in fp32;
- ``high`` — the library default. Inside the trailing-update kernel it is
  the reference's bf16x3 product (``x = hi + lo`` in bf16, three partial
  products summed in fp32 — ``dla_tpu/kernels/pallas_tiles.py:_dot_nt``);
  outside the kernel it is an IEEE fp32 ``torch.matmul``;
- ``highest`` (alias ``float32``) — IEEE fp32.

TF32 is never used: it keeps a 10-bit mantissa and is not the reference's
``high``. :func:`pin_ieee_fp32` switches it off for cuBLAS and cuDNN, and the
package calls it on import. fp64 and bf16-storage paths ignore the tier.
"""

from __future__ import annotations

import contextlib
import os

import torch

_VALID = ("default", "high", "highest", "float32", "fastest")

DEFAULT = "high"

_override: str | None = None

# canonical tier for each accepted name
_TIER = {"default": "default", "fastest": "default", "high": "high",
         "highest": "highest", "float32": "highest"}


def matmul_precision() -> str:
    if _override is not None:
        return _override
    p = os.environ.get("DLA_TPU_MATMUL_PRECISION", DEFAULT).lower()
    if p not in _VALID:
        raise ValueError(f"DLA_TPU_MATMUL_PRECISION must be one of {_VALID}")
    return p


def tier() -> str:
    """The active precision as one of ``default``, ``high``, ``highest``."""
    return _TIER[matmul_precision()]


@contextlib.contextmanager
def override(precision: str | None):
    """Matmul-precision override for the calls made inside the block (no-op
    for ``None``). Algorithms that take a ``precision`` argument wrap their
    body in this."""
    global _override
    if precision is None:
        yield
        return
    p = precision.lower()
    if p not in _VALID:
        raise ValueError(f"precision must be one of {_VALID}, got {precision!r}")
    prev = _override
    _override = p
    try:
        yield
    finally:
        _override = prev


def pin_ieee_fp32() -> None:
    """Keep every fp32 product outside the kernels in IEEE fp32: no TF32 in
    cuBLAS matmuls or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
