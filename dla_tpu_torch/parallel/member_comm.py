"""The collectives of the distributed planes on a member mesh, within one
process and across the process boundary, and where a mesh puts its members.

**Placement** (:func:`place`, the rule of ``make_flat_mesh`` and
``make_mesh``). JAX's ``devices=`` gives one device per member, in member
order; an explicit ``device=`` keeps every member on that one device; with
neither, the members spread evenly over the visible cards: k cards, k the
largest divisor of the member count that is at most
``torch.cuda.device_count()``, member m on card ``m // (size // k)``,
contiguous in member order as :class:`ProcessSpan` splits members over
processes. A mesh's members lie all on the CPU or all on CUDA cards
(:func:`check_devices`); where they span cards, every pair of them must reach
each other's memory (peer access over NVLink), or the mesh raises naming the
pair: there is no staging through the host.

**Collectives.** The JAX package runs these planes as ``shard_map`` programs
whose collectives are XLA's ``psum`` and ``all_gather``. Here each becomes a
plain torch operation, and the planes call them only through this module:

- a **masked psum** (every member adds its block, all but the owner's masked
  to zero) is a copy of the one owner's block: adding zeros changes no bit;
- an **all_gather** over a mesh axis is a stack (or, tiled, a concatenation)
  of the members' blocks;
- a **psum** of several members' nonzero parts is their sum in member order
  (XLA may add them in another order: the bits may differ).

A block reaches a member on another card through :func:`copy_to`, a peer copy
(``non_blocking=True``) that PyTorch orders between the two cards' current
streams without a host wait; :func:`share` and :func:`from_owner` take the
receiving card as ``device``, and :func:`all_gather`, :func:`all_gather_tiled`
and :func:`psum` are given blocks already delivered onto the receiver's card.
The products on the same shapes on cards of one model give the bits of a mesh
on one card.

**Across processes.** A mesh made while a ``torch.distributed`` process group
of more than one process is up (:mod:`~dla_tpu_torch.parallel.multihost`)
spans its processes: member m lives on process ``m // per_process``, as
``jax.devices()`` lists process 0's devices first. A process holds and
computes only its own members (a shard list holds None for the others), on
the one card of that process (NCCL: a card per process) or the CPU. A block
crosses the boundary only through :func:`share` (and :func:`from_owner`,
which is built on it): one ``torch.distributed`` broadcast from the owner's
process, which every process enters in the same order. An all-gather is then
a broadcast per member, stacked in member order (:func:`all_gather` of the
received blocks), and a psum of several parts a broadcast per part, added in
member order (:func:`psum`), so a plane gives the bits it gives in one
process. Only broadcasts cross: gloo, the backend for processes that share a
card, lists no ``all_gather`` or ``send`` for CUDA tensors, and stages each
broadcast through host memory.

:data:`boundary` counts this process's boundary broadcasts, their bytes and
their seconds on the host's clock. Each broadcast of a CUDA tensor is
bracketed by two ``torch.cuda.synchronize()`` calls of its card, so its
seconds hold the crossing and the wait for the other processes, not work the
device had queued before it.
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


def member_device(device) -> torch.device:
    """``device`` as a member's device: a bare "cuda" is the current card
    (raises without one)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def place(size: int, devices=None, device=None, processes: int = 1) -> tuple:
    """The members' devices of a mesh of ``size`` members (the rule in this
    module's docstring): ``devices``, one per member; else ``device`` for
    every member; else spread over the visible cards (on a mesh across
    ``processes`` > 1, every member on this process's card)."""
    if devices is not None and device is not None:
        raise ValueError("give a mesh devices= (one per member) or device= (all members), "
                         "not both")
    if devices is not None:
        devs = tuple(member_device(d) for d in devices)
        if len(devs) != size:
            raise ValueError(f"{size} members need {size} devices, got {len(devs)}")
        return devs
    if device is not None or processes > 1:
        return (member_device("cuda" if device is None else device),) * size
    ncards = torch.cuda.device_count()
    if ncards < 1:
        raise RuntimeError("no CUDA device is available for the mesh's members; pass "
                           "device='cpu' to place them on the CPU")
    k = max(c for c in range(1, min(ncards, size) + 1) if size % c == 0)
    return tuple(torch.device("cuda", m // (size // k)) for m in range(size))


def _peer_access(a: int, b: int) -> bool:
    """Whether card ``a`` can reach card ``b``'s memory."""
    return torch.cuda.can_device_access_peer(a, b)


def check_devices(devices) -> None:
    """A mesh's members: at least one, all on the CPU or all on CUDA cards,
    and every pair of its cards able to reach each other's memory."""
    if not devices:
        raise ValueError("a mesh needs at least one member")
    types = {d.type for d in devices}
    if types not in ({"cpu"}, {"cuda"}):
        raise ValueError(f"a mesh's members lie all on the CPU or all on CUDA cards; got "
                         f"{sorted({str(d) for d in devices})}")
    cards = sorted({d.index for d in devices if d.type == "cuda"})
    for a in cards:
        for b in cards:
            if a != b and not _peer_access(a, b):
                raise RuntimeError(f"the mesh spans cards {a} and {b}, and card {a} cannot "
                                   f"reach card {b}'s memory (no peer access): the members "
                                   "exchange blocks by peer copies only, never through the host")


def on(device):
    """Work of a member on ``device``: that card current (its cuBLAS handle
    and stream), or nothing to do on the CPU."""
    device = torch.device(device)
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def cards_of(devices) -> list:
    """The distinct devices of ``devices``, in their first member's order."""
    return list(dict.fromkeys(devices))


def synchronize(devices) -> None:
    """Wait for every card among ``devices`` (nothing on the CPU)."""
    for d in cards_of(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def copy_to(block, device):
    """``block`` on ``device``: itself where it lies there (or ``device`` is
    None), else a peer copy, ordered between the two cards' streams."""
    if block is None or device is None or block.device == device:
        return block
    return block.to(device, non_blocking=True)


class ProcessSpan:
    """The process span of a mesh with ``size`` members, the fields
    ``processes`` and ``process`` and the members' ``devices``: member m on
    process m // per_process, on ``devices[m]``."""

    def _check_span(self) -> None:
        check_devices(self.devices)
        self._check_processes()

    def device_of(self, m: int) -> torch.device:
        """Member m's device."""
        return self.devices[m]

    @property
    def device(self) -> torch.device:
        """Member 0's device, where assembled results land."""
        return self.devices[0]

    @property
    def cards(self) -> list:
        """The mesh's distinct devices, in member order."""
        return cards_of(self.devices)

    def _check_processes(self) -> None:
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
    """Run the block-cyclic planes' collectives over ``mesh``: inside,
    :func:`placed` is the mesh, and :func:`active` the mesh where it spans
    processes (else None)."""
    token = _active.set(mesh)
    try:
        yield
    finally:
        _active.reset(token)


def active():
    """The process-spanning mesh of the enclosing :func:`over`, or None."""
    mesh = _active.get()
    return mesh if mesh is not None and mesh.spans_processes else None


def placed():
    """The mesh of the enclosing :func:`over` (None outside one): where the
    block-cyclic planes find each member's card."""
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


def share(block, owner: int, shape, dtype, mesh=None, device=None) -> torch.Tensor:
    """Member ``owner``'s block on every process, on ``device`` (default:
    where it lies, or arrives): in one process the block itself, or its peer
    copy on ``device``; across processes a broadcast from the owner's process,
    whose ``block`` is the tensor to send (None on every other process, which
    receives a new (shape, dtype) tensor on its members' card)."""
    mesh = active() if mesh is None else mesh
    if mesh is None or not mesh.spans_processes:
        return copy_to(block, device)
    src = mesh.process_of(owner)
    if src == mesh.process:
        buf = block.contiguous()
    else:
        buf = torch.empty(tuple(shape), dtype=dtype,
                          device=mesh.device_of(mesh.local_members()[0]))
    _broadcast(buf, src)
    return copy_to(buf, device)


def from_owner(block, owner: int, shape, dtype, mesh=None, device=None) -> torch.Tensor:
    """The owner's block as every member receives it from a masked psum: a
    new tensor, :func:`share` of a copy, on ``device`` (default: the owner's
    card, or this process's)."""
    return share(None if block is None else block.clone(), owner, shape, dtype, mesh, device)


def all_gather(blocks) -> torch.Tensor:
    """The members' equally shaped blocks, on the receiver's card, stacked
    along a new leading axis."""
    return torch.stack(list(blocks))


def all_gather_tiled(blocks) -> torch.Tensor:
    """The members' blocks, on the receiver's card, concatenated along their
    rows."""
    return torch.cat(list(blocks), dim=0)


def psum(parts) -> torch.Tensor:
    """The sum of the members' parts, on the receiver's card, added in member
    order."""
    parts = list(parts)
    out = parts[0].clone()
    for t in parts[1:]:
        out += t
    return out
