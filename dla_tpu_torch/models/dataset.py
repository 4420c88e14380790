"""Epoch-shuffled minibatcher (↔ ``z/dataset.py``).

A copy of ``dla_tpu/models/dataset.py``: it is framework-neutral, but
importing anything under ``dla_tpu`` imports jax, which the port never does.
"""

from __future__ import annotations

import numpy as np


class DataSet:
    """Shuffles once per epoch and yields minibatches (the reference's
    ``DataSet.next_batch`` semantics, generator-style)."""

    def __init__(self, x: np.ndarray, y: np.ndarray, *, seed: int = 0):
        assert len(x) == len(y)
        self.x, self.y = x, y
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.x)

    def epoch(self, batch_size: int):
        order = self._rng.permutation(len(self.x))
        for i in range(0, len(order), batch_size):
            idx = order[i : i + batch_size]
            yield self.x[idx], self.y[idx]
