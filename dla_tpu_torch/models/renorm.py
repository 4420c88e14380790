"""Custom layers (↔ ``z/renormalization.py`` and ``z/relu_activation.py``).

The port of ``dla_tpu/models/renorm.py`` to ``torch.nn``:

- :class:`BatchRenorm` — Batch Renormalization (Ioffe 2017): batch norm with
  per-batch (r, d) corrections toward the running statistics, clipped to
  [1/rmax, rmax] and [−dmax, dmax], so train and inference statistics agree
  on small/correlated batches. The running statistics are buffers (flax's
  ``batch_stats`` collection), updated on every training forward; r and d
  are detached, as JAX's ``stop_gradient``.
- :func:`birelu` — the reference's BiReLU activation (``relu_activation.py``):
  sign-preserving rectification y = relu(x) − relu(−x) with a leak slope.
"""

from __future__ import annotations

import torch
from torch import nn


class BatchRenorm(nn.Module):
    """Batch Renormalization over the last axis (``num_features`` wide)."""

    def __init__(self, num_features: int, *, rmax: float = 3.0, dmax: float = 5.0,
                 momentum: float = 0.99, epsilon: float = 1e-5):
        super().__init__()
        self.rmax, self.dmax, self.momentum, self.epsilon = rmax, dmax, momentum, epsilon
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.gamma = nn.Parameter(torch.ones(num_features))
        self.beta = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            axes = tuple(range(x.ndim - 1))
            mean = x.mean(dim=axes)
            var = x.var(dim=axes, unbiased=False)  # population variance, as jnp.var
            sigma = torch.sqrt(var + self.epsilon)
            ra_sigma = torch.sqrt(self.running_var + self.epsilon)
            r = torch.clamp(sigma / ra_sigma, 1.0 / self.rmax, self.rmax).detach()
            d = torch.clamp((mean - self.running_mean) / ra_sigma,
                            -self.dmax, self.dmax).detach()
            xhat = (x - mean) / sigma * r + d
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            xhat = (x - self.running_mean) / torch.sqrt(self.running_var + self.epsilon)
        return self.gamma * xhat + self.beta


def birelu(x: torch.Tensor, leak: float = 0.01) -> torch.Tensor:
    """Sign-preserving rectification: positive and negative parts both pass,
    small values are attenuated by ``leak``."""
    return torch.clamp(x, min=0.0) + leak * torch.clamp(x, max=0.0)
