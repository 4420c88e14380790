"""Entry ``potrs``: ``algos.potrs`` on the factor that set-up makes with the
configuration's own entry (its ``factorize``) and keeps (the ``closed``
loop). Each query's right-hand sides are drawn on the card from one
generator of the seed as its client makes the query, so no two queries of a
run share them.

Its check: every kept query's X against the reference's float64 solve of its
own right-hand sides, with the reference's own factor of the matrix, worked
out again from the seed.
"""

from __future__ import annotations

import torch

from portbench import check, inputs
from portbench.program import Sut, entry
from portbench.reference import cholesky, compare


class Solve(Sut):
    def __init__(self, config: dict, seed: int, device, control: bool):
        super().__init__(config, device, control)
        import dla_tpu_torch.algos as TA

        self._solve = TA.potrs
        self.given = getattr(torch, config["dtype"])
        a = inputs.spd_dense(config["n"], self.given, device, seed).to(self.dtype)
        self.factor = entry(config["entry"]).factorize(self, a)
        self._draw = inputs.generator(device, seed, "B")
        self.sync()

    def submit(self, width: int) -> tuple:
        """Make one query of ``width`` right-hand sides, uniform on [-0.5,
        0.5) in the configuration's dtype, and enqueue its solve: (B, X)."""
        b = torch.rand((self.config["n"], width), generator=self._draw, dtype=self.given,
                       device=self.devices[0]).sub_(0.5)
        return b, self._solve(self.factor, b.to(self.dtype))


def system(config: dict, traffic: dict, seed: int, device, control: bool) -> Solve:
    return Solve(config, seed, device, control)


def numbers(sut: Solve, kept: dict, seed: int) -> tuple:
    """{"solve_err": the largest error} and {seq: each query's error}."""
    cfg = sut.config
    nb, dev = cfg["nb"], sut.devices[0]
    sut.factor = None
    check.release(dev)
    panels = check.panels(inputs.spd_dense(cfg["n"], sut.given, dev, seed), nb)
    check.release(dev)
    cholesky.factor(panels, nb)
    errs = {seq: compare.solve_err(x, cholesky.solve(panels, b, nb))
            for seq, (_, (b, x)) in sorted(kept.items())}
    worst = torch.tensor(list(errs.values()), dtype=torch.float64).amax().item()
    return {"solve_err": worst}, errs
