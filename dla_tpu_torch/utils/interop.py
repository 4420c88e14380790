"""Moving matrices between numpy and the port's tensors.

``np.asarray`` of a JAX array gives a numpy array; bf16 arrives there as
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses, so bf16 crosses
as its raw 16-bit pattern. Both directions copy: the port's ``potrf_inplace``
mutates its argument, and that must never reach the caller's array.
"""

from __future__ import annotations

import numpy as np
import torch


def from_numpy(a, *, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """Copy a numpy array (or anything ``np.asarray`` takes) to a tensor on
    ``device``, optionally cast to ``dtype``."""
    a = np.array(a, order="C")  # a private, writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Copy a tensor to a host numpy array; bf16 comes back as
    ``ml_dtypes.bfloat16`` (imported only for that case)."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().copy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()
