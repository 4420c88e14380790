"""Column-cyclic distributed POTRF on a flat mesh, with the ring broadcast as
the panel data plane — counterpart of ``dla_tpu/parallel/column_cyclic.py``.

The mesh is a :class:`FlatMesh` of D members. In the JAX package each member
is a device of a ``shard_map``; here the members lie on one card or spread
over the cards of one host (:func:`make_flat_mesh`, the placement rule of
:mod:`~dla_tpu_torch.parallel.member_comm`), and each holds allocations of its
own. A sharded matrix is a list of D tensors, member d's on
``mesh.devices[d]``: exactly the block JAX's ``NamedSharding(mesh, P(None,
"d"))`` puts on device d, so the shards concatenated in member order are
JAX's global array. Data crosses between members only through
:func:`~dla_tpu_torch.kernels.collectives.ring_broadcast`, over NVLink where
they lie on different cards.

A mesh made while a process group of several processes is up spans them
(:mod:`~dla_tpu_torch.parallel.member_comm`): a process holds its own
members' shards (None for the others) and runs only their programs, and the
ring broadcast has two levels with the same bits: the owner's block crosses
to every other process by one ``torch.distributed`` broadcast, then #11 runs
among each process's members, rooted at the member in the owner's position.

Algorithm (right-looking, lower triangle only), tile column j owned by member
j mod D. The controller runs each member's program in turn, on its card's
current stream, and never waits for a card: each card runs its own members'
work while the controller moves on, so the cards overlap:

1. the owner solves panel k (the Cholesky factor of the diagonal tile, then
   one triangular solve of the rows below);
2. the solved panel rides the ring to the other D−1 members (two broadcasts:
   the nb×nb factor tile, then the (N−(k+1)·nb)×nb panel; 2·nt − 1 in all);
3. every member updates its tile columns right of k from the static staircase
   row start ``max(k+1, lj·D)·nb``, as JAX does. A member's tile column left
   of k + 1 is masked to a zero update in JAX (``gcol > k``); here it is
   skipped, which leaves the same bits.

The trailing products are ``torch.matmul``, as they are plain XLA products in
JAX. Numerics meet the 1e-10 fp64 gate of every other factorization path.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from dla_tpu_torch.algos.potrf import _cholesky
from dla_tpu_torch.kernels.collectives import ring_broadcast
from dla_tpu_torch.parallel import member_comm as comm

@dataclass(frozen=True)
class FlatMesh(comm.ProcessSpan):
    """A 1-D ('d',) mesh of ``len(devices)`` members, member d on
    ``devices[d]``, split evenly over ``processes`` processes, of which this is
    ``process``. The members lie all on the CPU or all on CUDA cards, one card
    or several that reach each other's memory (else ``ValueError`` /
    ``RuntimeError``); ``device`` is member 0's."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("d",)
    processes: int = 1
    process: int = 0

    def __post_init__(self):
        self._check_span()

    @property
    def size(self) -> int:
        return len(self.devices)


def make_flat_mesh(ndev: int, *, devices=None, device=None) -> FlatMesh:
    """A flat mesh of ``ndev`` members: on ``devices`` (one per member, JAX's
    argument), all on ``device``, or by default spread evenly over the
    visible cards (:func:`~dla_tpu_torch.parallel.member_comm.place`); across
    the processes of the process group where one is up, as ``jax.devices()``
    spans them."""
    processes, process = comm.process_span()
    return FlatMesh(comm.place(ndev, devices, device, processes), processes=processes,
                    process=process)


def _tensor(a) -> torch.Tensor:
    """``a`` as a tensor: a numpy array (or anything ``np.array`` takes) is
    copied, a tensor kept."""
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


def _col_perm(n: int, nb: int, ndev: int) -> np.ndarray:
    """Column permutation grouping each device's cyclic tile columns
    contiguously (cyclic → blocked, columns only)."""
    nt = n // nb
    order = []
    for d in range(ndev):
        for j in range(d, nt, ndev):
            order.extend(range(j * nb, (j + 1) * nb))
    return np.asarray(order)


def from_dense_cols(a, nb: int, mesh: FlatMesh) -> list[torch.Tensor]:
    """Permute and shard a dense (n, n) matrix (tensor or numpy)
    column-cyclically over the flat mesh: one (n, n/D) tensor per member, rows
    whole on every member (None for another process's member)."""
    a = _tensor(a)
    perm = torch.as_tensor(_col_perm(a.shape[1], nb, mesh.size), device=a.device)
    w = a.shape[1] // mesh.size
    full = a[:, perm]
    return [full[:, d * w : (d + 1) * w].to(mesh.devices[d], copy=True).contiguous()
            if mesh.is_local(d) else None for d in range(mesh.size)]


def _gathered(shards, mesh) -> list[torch.Tensor]:
    """Every member's shard on this process, on its first member's device
    (JAX's replicate step): across processes, each other process's shards
    arrive by broadcast, in member order; from other cards by peer copy."""
    x = list(shards)
    ref = x[mesh.local_members()[0]]
    return [comm.share(x[d], d, ref.shape, ref.dtype, mesh, ref.device)
            for d in range(mesh.size)]


def to_dense_cols(shards, nb: int, mesh: FlatMesh) -> torch.Tensor:
    """Inverse of :func:`from_dense_cols`: the dense matrix, on member 0's
    device (the JAX function gathers it to the host); across processes, on
    every process."""
    x = torch.cat(_gathered(shards, mesh), dim=1)
    perm = _col_perm(x.shape[1], nb, mesh.size)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return x[:, torch.as_tensor(inv, device=x.device)]


def _solve_panel(d: torch.Tensor, col: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The owner's panel: tril(chol(d)) from d's lower triangle, and
    col·L⁻ᵀ, both row-major."""
    lkk = torch.tril(_cholesky(d))
    if col.shape[0]:
        col = torch.linalg.solve_triangular(lkk.mT, col, upper=True, left=False)
    return lkk, col.contiguous()


def _dot_nt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·bᵀ in the storage dtype, accumulated in fp32 for bf16/fp16 (JAX's
    ``preferred_element_type``)."""
    if a.dtype in (torch.bfloat16, torch.float16):
        return (a.float() @ b.float().mT).to(a.dtype)
    return a @ b.mT


@functools.cache
def _placeholder(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """One element on ``device``: a non-root member's block for the ring."""
    return torch.zeros((), dtype=dtype, device=device)


def _broadcast_from(owner: int, block, mesh: FlatMesh, shape, dtype) -> list:
    """Ring-broadcast the owner's block: every other member hands the ring a
    block of its own, whose contents the ring ignores. Every plane broadcasts
    through here (through this module's ``ring_broadcast``, which a test or a
    timing run may replace). Across processes ``block`` is None on every
    process but the owner's: the block crosses to each process first
    (:func:`~dla_tpu_torch.parallel.member_comm.share`), then the ring runs
    among the process's members from the one in the owner's position; the
    list holds None for other processes' members. Each output lies on its
    member's card. The other members hand the ring one element of their own
    card, expanded to the block's shape (made once per card and dtype): the
    ring reads only the root's block."""
    blk = comm.share(block, owner, shape, dtype, mesh)
    root = owner % mesh.per_process
    outs = ring_broadcast([blk if i == root else _placeholder(mesh.device_of(d), blk.dtype)
                           .expand(blk.shape) for i, d in enumerate(mesh.local_members())], root)
    full = [None] * mesh.size
    for d, out in zip(mesh.local_members(), outs):
        full[d] = out
    return full


def _local_shards(x: list, mesh, want: tuple, what: str) -> torch.Tensor:
    """Checks this process's shards of ``x`` (D entries, ``want``-shaped);
    returns the first."""
    local = [x[d] for d in mesh.local_members()] if len(x) == mesh.size else []
    if not local or any(s is None or tuple(s.shape) != want for s in local):
        raise ValueError(f"need {mesh.size} {what} of shape {want}; got "
                         f"{[None if s is None else tuple(s.shape) for s in x]}")
    return local[0]


def _check(n: int, nb: int, mesh, name: str) -> int:
    if n % nb:
        raise ValueError(f"n={n} must be a multiple of nb={nb}")
    nt = n // nb
    if nt % mesh.size:
        raise ValueError(f"nt={nt} tile columns must be a multiple of mesh size {mesh.size}")
    if len(mesh.axis_names) != 1:
        raise ValueError(
            f"{name} needs a flat 1-D mesh (Pallas remote DMA cannot address multi-axis "
            "meshes); use make_flat_mesh")
    return nt


def potrf_column_cyclic_ring(shards, nb: int, mesh: FlatMesh) -> list[torch.Tensor]:
    """Distributed POTRF of a column-cyclic sharded matrix (see
    :func:`from_dense_cols`) with ring panel broadcasts. Requires nt = n/nb to
    be a multiple of the mesh size. **Factors in place**: the returned list
    holds the input shards, updated (JAX returns new arrays in the same
    layout; across processes, this process's shards and None for the
    others). Only the lower triangle is meaningful."""
    x = list(shards)
    first = next((s for s in x if s is not None), None)
    n = 0 if first is None else first.shape[0]
    nt = _check(n, nb, mesh, "potrf_column_cyclic_ring")
    ndev = mesh.size
    dtype = _local_shards(x, mesh, (n, n // ndev), "shards").dtype
    ltc = nt // ndev
    for k in range(nt):
        kc, ljk = k % ndev, k // ndev
        row0, row1 = k * nb, (k + 1) * nb
        cols = slice(ljk * nb, (ljk + 1) * nb)
        own = x[kc] if mesh.is_local(kc) else None
        lkk = solved = None
        if own is not None:
            with comm.on(own.device):
                lkk, solved = _solve_panel(own[row0:row1, cols], own[row1:, cols])
                own[row0:row1, cols] = lkk
        _broadcast_from(kc, lkk, mesh, (nb, nb), dtype)  # every member receives L_kk
        if k == nt - 1:
            break
        panel = _broadcast_from(kc, solved, mesh, (n - row1, nb), dtype)
        if own is not None:
            own[row1:, cols] = solved
        for c in mesh.local_members():  # each member's trailing update over its own shard
            with comm.on(x[c].device):
                for lj in range((k + 1) // ndev, ltc):
                    gcol = lj * ndev + c
                    rs = max(k + 1, lj * ndev) * nb
                    if gcol <= k or rs >= n:
                        continue
                    off = gcol * nb - row1
                    b = panel[c][off : off + nb]
                    x[c][rs:, lj * nb : (lj + 1) * nb] -= _dot_nt(panel[c][rs - row1 :], b)
    return x
