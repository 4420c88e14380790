"""The collectives of the block-cyclic, solve and serving planes on a member
mesh whose members share one device.

The JAX package runs these planes as ``shard_map`` programs whose
collectives are XLA's ``psum`` and ``all_gather``. With every member on one
device each becomes a plain torch operation, and the planes call them only
through this module, so that members on several cards (ROADMAP A9c) can
swap in peer copies here:

- a **masked psum** (every member adds its block, all but the owner's masked
  to zero) is a copy of the one owner's block: adding zeros changes no bit;
- an **all_gather** over a mesh axis is a stack (or, tiled, a concatenation)
  of the members' blocks;
- a **psum** of several members' nonzero parts is their sum in member order
  (XLA may add them in another order: the bits may differ).
"""

from __future__ import annotations

import torch


def from_owner(block: torch.Tensor) -> torch.Tensor:
    """The owner's block as every member receives it from a masked psum."""
    return block.clone()


def all_gather(blocks) -> torch.Tensor:
    """The members' equally shaped blocks stacked along a new leading axis."""
    return torch.stack(list(blocks))


def all_gather_tiled(blocks) -> torch.Tensor:
    """The members' blocks concatenated along their rows."""
    return torch.cat(list(blocks), dim=0)


def psum(parts) -> torch.Tensor:
    """The sum of the members' parts, added in member order."""
    parts = list(parts)
    out = parts[0].clone()
    for t in parts[1:]:
        out += t
    return out
