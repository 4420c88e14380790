"""Entry ``potrf_inplace``: ``algos.potrf_inplace`` on one card, factoring in
place a working buffer restaged from the pristine matrix before each
factorization (the ``back_to_back`` loop).

Its check: the factor of the window's last factorization, its whole lower
triangle, against the reference's float64 factor of the same matrix (the
input the benchmark made, with that factorization's diagonal shift), column
panel by column panel.
"""

from __future__ import annotations

import torch

from portbench import check, inputs
from portbench.program import Sut, shift
from portbench.reference import cholesky, compare


def factorize(sut: Sut, a: torch.Tensor) -> torch.Tensor:
    """Factor ``a`` in place with the configuration's keyword arguments; the
    factor (its lower triangle)."""
    import dla_tpu_torch.algos as TA

    return TA.potrf_inplace(a, **sut.kwargs())


class DenseFactor(Sut):
    def __init__(self, config: dict, seed: int, device, control: bool):
        super().__init__(config, device, control)
        # the matrix in the configuration's dtype, and as the program factors it
        self.source = inputs.spd_dense(config["n"], getattr(torch, config["dtype"]), device, seed)
        self.pristine = self.source.to(self.dtype)
        self.work = torch.empty_like(self.pristine)
        self.index = 0

    def restage(self, i: int) -> None:
        self.index = i
        self.work.copy_(self.pristine)
        self.work.diagonal().add_(shift(i))

    def run(self) -> None:
        factorize(self, self.work)


def system(config: dict, traffic: dict, seed: int, device, control: bool) -> DenseFactor:
    return DenseFactor(config, seed, device, control)


def numbers(sut: DenseFactor, kept: dict, seed: int) -> tuple:
    """{"factor_err": its value} and {the factorization's index: the same}."""
    nb = sut.config["nb"]
    panels = check.panels(sut.source, nb)
    for p in panels:
        p[:nb].diagonal().add_(shift(sut.index))
    sut.pristine = sut.source = None  # the input is in the panels now
    check.release(*sut.devices)
    cholesky.factor(panels, nb)
    parts = [compare.factor_parts(inputs.column(sut.work, nb, j, torch.float64), ref, nb)
             for j, ref in enumerate(panels)]
    err = compare.factor_err(parts)
    return {"factor_err": err}, {sut.index: err}
