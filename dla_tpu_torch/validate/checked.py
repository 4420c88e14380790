"""Checked factorization — counterpart of ``dla_tpu/validate/checked.py``.

The reference worker turns a failed ``dpotrf`` (``info != 0``, a non-SPD
pivot) into an error status, and counts NaN/Inf in every task
(``worker_distrib.cpp:120-148,243-244``). The JAX package gets the same from
``jax.experimental.checkify``: the factor comes back with an error value the
caller can inspect or raise. Here the three checks are explicit tensor
reductions on the factor's device, stacked into one flag vector, so one host
read (the first ``get()`` or ``throw()``) answers all three.
"""

from __future__ import annotations

import torch

from dla_tpu_torch.algos.potrf import potrf_blocked

#: the reference's checks, in its order, with its messages (``checked.py:30-43``)
MESSAGES = (
    "POTRF produced NaNs — input not SPD (non-positive pivot)",
    "POTRF produced Infs — input ill-scaled or not SPD",
    "POTRF: non-positive diagonal in factor — input not SPD",
)


class CheckError:
    """The outcome of :func:`potrf_checked`: ``get()`` returns the first
    failed check's message as checkify words it (the message, then
    ``(`check` failed)``), or None; ``throw()`` raises it."""

    def __init__(self, flags: torch.Tensor):
        self._flags = flags
        self._read: list[bool] | None = None

    def get(self) -> str | None:
        if self._read is None:
            self._read = [bool(f) for f in self._flags.tolist()]  # the one host read
        return next((f"{m} (`check` failed)" for m, bad in zip(MESSAGES, self._read) if bad),
                    None)

    def throw(self) -> None:
        msg = self.get()
        if msg is not None:
            raise RuntimeError(msg)


def potrf_checked(a: torch.Tensor, *, nb: int = 256, **kw) -> tuple[CheckError, torch.Tensor]:
    """Factor with error checking: returns ``(err, L)`` from
    :func:`~dla_tpu_torch.algos.potrf.potrf_blocked` (``kw`` goes to it).
    The checks: no NaN in the factor, no Inf, a strictly positive (real)
    diagonal — the replacement for LAPACK's ``info``."""
    l = potrf_blocked(a, nb=nb, **kw)
    diag = torch.diagonal(l)
    diag = diag.real if diag.is_complex() else diag
    flags = torch.stack([torch.isnan(l).any(), torch.isinf(l).any(),
                         torch.logical_not((diag > 0).all())])
    return CheckError(flags), l
