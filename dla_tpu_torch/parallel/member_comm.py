"""The collectives of the distributed planes on a member mesh, within one
process and across the process boundary.

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

**Across processes.** A mesh made while a ``torch.distributed`` process group
of more than one process is up (:mod:`~dla_tpu_torch.parallel.multihost`)
spans its processes: member m lives on process ``m // per_process``, as
``jax.devices()`` lists process 0's devices first. A process holds and
computes only its own members (a shard list holds None for the others), on
one device. A block crosses the boundary only through :func:`share` (and
:func:`from_owner`, which is built on it): one ``torch.distributed``
broadcast from the owner's process, which every process enters in the same
order. An all-gather is then a broadcast per member, stacked in member order
(:func:`all_gather` of the received blocks), and a psum of several parts a
broadcast per part, added in member order (:func:`psum`), so a plane gives
the bits it gives in one process. Only broadcasts cross: gloo, the backend
for processes that share a card, lists no ``all_gather`` or ``send`` for
CUDA tensors, and stages each broadcast through host memory.

:data:`boundary` counts this process's boundary broadcasts, their bytes and
their seconds on the host's clock. Each broadcast of a CUDA tensor is
bracketed by two ``torch.cuda.synchronize()`` calls, so its seconds hold the
crossing and the wait for the other processes, not work the device had
queued before it.
"""

from __future__ import annotations

import contextlib
import contextvars
import time

import torch

#: this process's boundary broadcasts: how many, their bytes, their seconds
boundary = {"calls": 0, "bytes": 0, "seconds": 0.0}

_active = contextvars.ContextVar("dla_member_comm_mesh", default=None)


def process_span() -> tuple[int, int]:
    """(processes, this process's index) of the default ``torch.distributed``
    process group, or (1, 0) where none is up."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class ProcessSpan:
    """The process span of a mesh with ``size`` members and the fields
    ``processes`` and ``process``: member m on process m // per_process."""

    def _check_span(self) -> None:
        if self.processes < 1 or self.size % self.processes:
            raise ValueError(f"{self.size} members cannot be split evenly over "
                             f"{self.processes} processes")
        if not 0 <= self.process < self.processes:
            raise ValueError(f"process {self.process} is not one of {self.processes}")

    @property
    def spans_processes(self) -> bool:
        return self.processes > 1

    @property
    def per_process(self) -> int:
        return self.size // self.processes

    def process_of(self, m: int) -> int:
        return m // self.per_process

    def is_local(self, m: int) -> bool:
        return self.process_of(m) == self.process

    def local_members(self) -> range:
        """This process's members, in mesh order."""
        return range(self.process * self.per_process, (self.process + 1) * self.per_process)


@contextlib.contextmanager
def over(mesh):
    """Run the block-cyclic planes' collectives over ``mesh``'s processes:
    inside, :func:`active` is the mesh where it spans processes (else None)."""
    token = _active.set(mesh if mesh.spans_processes else None)
    try:
        yield
    finally:
        _active.reset(token)


def active():
    """The process-spanning mesh of the enclosing :func:`over`, or None."""
    return _active.get()


def _broadcast(buf: torch.Tensor, src: int) -> None:
    import torch.distributed as dist

    if buf.is_cuda:
        torch.cuda.synchronize(buf.device)
    t0 = time.perf_counter()
    dist.broadcast(buf, src=src)
    if buf.is_cuda:
        torch.cuda.synchronize(buf.device)
    boundary["seconds"] += time.perf_counter() - t0
    boundary["calls"] += 1
    boundary["bytes"] += buf.numel() * buf.element_size()


def share(block, owner: int, shape, dtype, mesh=None) -> torch.Tensor:
    """Member ``owner``'s block on every process: in one process the block
    itself; across processes a broadcast from the owner's process, whose
    ``block`` is the tensor to send (None on every other process, which
    receives a new (shape, dtype) tensor on its device)."""
    mesh = active() if mesh is None else mesh
    if mesh is None or not mesh.spans_processes:
        return block
    src = mesh.process_of(owner)
    if src == mesh.process:
        buf = block.contiguous()
    else:
        buf = torch.empty(tuple(shape), dtype=dtype, device=mesh.device)
    _broadcast(buf, src)
    return buf


def from_owner(block, owner: int, shape, dtype, mesh=None) -> torch.Tensor:
    """The owner's block as every member receives it from a masked psum: a
    new tensor, :func:`share` of a copy."""
    return share(None if block is None else block.clone(), owner, shape, dtype, mesh)


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
