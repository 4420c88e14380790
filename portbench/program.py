"""The system under test, found by name: the entry that a cell's window
drives is ``entries/<entry>.py``, where ``<entry>`` is the traffic mix's
``entry`` or, where the mix names none, the configuration's. An entry module
exports ``system(config, traffic, seed, device, control)``, the cell's state
on the card with what the window drives (``restage`` and ``run``, or
``submit``), and ``numbers(sut, kept, seed)``, the numbers its check compares
with the plain reference. Only the entry modules import the program,
``dla_tpu_torch``, and only its public functions.

The benchmark makes every input (:mod:`portbench.inputs`); the program gets
only those. A configuration's ``control`` switches on the program's own path
one precision below the configuration's (its ``precision`` and ``dtype``);
the benchmark's runs never set it.
"""

from __future__ import annotations

import importlib

import torch


def shift(i: int) -> float:
    """The diagonal shift of the i-th factorization of a run: a multiple of
    1/16, exact in every storage type and size of the cells, so no two
    neighbouring factorizations factor the same matrix."""
    return (i % 64) / 16


class Sut:
    """What every cell's system shares: the configuration, with its control
    applied where asked (``compute``), and the card."""

    def __init__(self, config: dict, device, control: bool):
        self.config = dict(config)
        self.compute = dict(config, **(config.get("control", {}) if control else {}))
        self.dtype = getattr(torch, self.compute["dtype"])
        self.devices = [torch.device(device)]

    def kwargs(self) -> dict:
        """The keyword arguments of the configuration's entry: the keys that
        its ``kwargs`` lists, as computed (control applied), where present."""
        return {k: self.compute[k] for k in self.config["kwargs"] if k in self.compute}

    def sync(self) -> None:
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)


def entry_name(config: dict, traffic: dict) -> str:
    return traffic.get("entry", config["entry"])


def entry(name: str):
    """The module ``entries/<name>.py``."""
    return importlib.import_module(f"portbench.entries.{name}")

