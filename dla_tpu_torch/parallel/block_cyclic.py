"""2D block-cyclic distribution of a tiled matrix over a p×q member mesh —
counterpart of ``dla_tpu/parallel/block_cyclic.py``.

Tile (i, j) of the nt×nt tile grid is owned by member (i mod p, j mod q). The
JAX package stores the matrix in a cyclic-permuted element order (global tile
row i at stored tile row ``(i mod p)·ltr + i // p``, the same for columns), so
that the cyclic layout becomes a blocked sharding ``P('r', 'c')``; each
device's local shard is a plain (ltr·nb, ltc·nb) matrix whose tile (li, lj) is
global tile (li·p + r, lj·q + c).

Here the p·q members lie on one card or spread over the cards of one host, as
the ring planes' :class:`FlatMesh` members do (the placement rule of
:mod:`~dla_tpu_torch.parallel.member_comm`), and a sharded matrix is a list of
p·q tensors, member (r, c) at index r·q + c on its own device: exactly the
block JAX's ``layout.sharding(mesh)`` puts on device (r, c), so assembling
the list in mesh order gives JAX's stored array.
A mesh made while a process group of several processes is up spans them
(:mod:`~dla_tpu_torch.parallel.member_comm`): a process's list holds its own
members' tensors and None for the others, and :func:`to_dense` brings the
others' over first (JAX's replicate step).
The permutation is never materialized as an index: a dense (n, n) matrix
viewed as (ltr, p, nb, ltc, q, nb) has member (r, c)'s tiles at ``[:, r, :,
:, c, :]``, so :func:`from_dense` and :func:`to_dense` are one strided copy
per member, onto the member's card (:func:`from_dense`) or back onto member
0's (:func:`to_dense`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dla_tpu_torch.ops.lapack_like import _SLAB_ELEMS, plgsy_at
from dla_tpu_torch.parallel import member_comm as comm
from dla_tpu_torch.parallel.column_cyclic import _tensor


@dataclasses.dataclass(frozen=True)
class MemberMesh(comm.ProcessSpan):
    """A 2-D ('r', 'c') mesh of p×q members — the PxQ process grid — member
    (r, c) at ``devices[r·q + c]``, split evenly over ``processes``
    processes, of which this is ``process``. It sits beside
    :class:`FlatMesh` (the ring planes' 1-D mesh, which they require) rather
    than generalizing it. Its members lie as a :class:`FlatMesh`'s do."""

    devices: tuple[torch.device, ...]
    shape: tuple[int, int]
    axis_names: tuple[str, ...] = ("r", "c")
    processes: int = 1
    process: int = 0

    def __post_init__(self):
        p, q = self.shape
        if p <= 0 or q <= 0 or len(self.devices) != p * q:
            raise ValueError(f"a {p}x{q} mesh needs {p * q} members, got {len(self.devices)}")
        self._check_span()

    @property
    def size(self) -> int:
        return len(self.devices)


def squarest(ndev: int) -> tuple[int, int]:
    """The squarest p×q grid of ndev members, p ≤ q."""
    p = int(np.sqrt(ndev))
    while ndev % p:
        p -= 1
    return p, ndev // p


def make_mesh(p: int, q: int, *, devices=None, device=None) -> MemberMesh:
    """A p×q member mesh with axes ('r', 'c'), member (r, c) on ``devices[r·q
    + c]`` (JAX's argument), all on ``device``, or by default spread evenly
    over the visible cards (:func:`~dla_tpu_torch.parallel.member_comm.place`);
    across the processes of the process group where one is up, as
    ``jax.devices()`` spans them."""
    processes, process = comm.process_span()
    return MemberMesh(comm.place(p * q, devices, device, processes), (p, q),
                      processes=processes, process=process)


@dataclasses.dataclass(frozen=True)
class BlockCyclicLayout:
    """Static geometry of a block-cyclic distributed N×N matrix."""

    n: int  # global matrix dim
    nb: int  # tile size
    p: int  # mesh rows
    q: int  # mesh cols

    def __post_init__(self):
        if self.n % self.nb:
            raise ValueError(f"n={self.n} must be a multiple of nb={self.nb}")
        if self.ntiles % self.p or self.ntiles % self.q:
            raise ValueError(
                f"tile grid {self.ntiles} must be divisible by mesh "
                f"({self.p}x{self.q}); pad n or choose a different nb"
            )

    @property
    def ntiles(self) -> int:
        return self.n // self.nb

    @property
    def ltr(self) -> int:
        """Local tile rows per member."""
        return self.ntiles // self.p

    @property
    def ltc(self) -> int:
        """Local tile cols per member."""
        return self.ntiles // self.q

    @property
    def local_shape(self) -> tuple[int, int]:
        return (self.ltr * self.nb, self.ltc * self.nb)

    # -- the cyclic→blocked element permutation ------------------------------

    def perm(self, axis_tiles_per_dev: int, procs: int) -> np.ndarray:
        """Element permutation for one axis: perm[stored] = global index."""
        nb = self.nb
        idx = np.arange(self.n)
        tile = idx // nb
        within = idx % nb
        # stored tile order: all tiles owned by proc 0 (in global order),
        # then proc 1, ... ; stored_tile = (tile % procs) * per + tile // procs
        stored_tile = (tile % procs) * axis_tiles_per_dev + tile // procs
        stored = stored_tile * nb + within
        perm = np.empty(self.n, np.int64)
        perm[stored] = idx
        return perm

    @property
    def row_perm(self) -> np.ndarray:
        return self.perm(self.ltr, self.p)

    @property
    def col_perm(self) -> np.ndarray:
        return self.perm(self.ltc, self.q)


def _members(layout: BlockCyclicLayout, mesh: MemberMesh | None = None):
    """(index, r, c) of every member of this process (of ``mesh``, else of
    the enclosing ``member_comm.over``; of every member where neither is
    given), in mesh order."""
    mesh = comm.active() if mesh is None else mesh
    return [(r * layout.q + c, r, c) for r in range(layout.p) for c in range(layout.q)
            if mesh is None or mesh.is_local(r * layout.q + c)]


def _tiles(a: torch.Tensor, layout: BlockCyclicLayout) -> torch.Tensor:
    """A dense (n, n) matrix as (ltr, p, nb, ltc, q, nb): member (r, c)'s
    tiles are ``[:, r, :, :, c, :]``."""
    lay = layout
    return a.view(lay.ltr, lay.p, lay.nb, lay.ltc, lay.q, lay.nb)


def _check_shards(shards, layout: BlockCyclicLayout, mesh: MemberMesh | None = None) -> list:
    """The shard list, checked against the layout (and the mesh's shape);
    on a mesh across processes, only this process's shards."""
    x = list(shards)
    if mesh is not None and tuple(mesh.shape) != (layout.p, layout.q):
        raise ValueError(f"mesh {mesh.shape} does not match the layout's {layout.p}x{layout.q}")
    mine = [x[m] for m, _, _ in _members(layout, mesh)] if len(x) == layout.p * layout.q else []
    if not mine or any(s is None or tuple(s.shape) != layout.local_shape for s in mine):
        raise ValueError(f"need {layout.p * layout.q} shards of shape {layout.local_shape}; "
                         f"got {[None if s is None else tuple(s.shape) for s in x]}")
    return x


def from_dense(a, layout: BlockCyclicLayout, mesh: MemberMesh) -> list[torch.Tensor]:
    """Dense (n, n) matrix (tensor or numpy) → one (ltr·nb, ltc·nb) tensor per
    member, each a copy on its member's device (None for another process's
    member). A tensor is read on its own device (a card tensor makes no trip
    through the host)."""
    a = _tensor(a).contiguous()
    if tuple(a.shape) != (layout.n, layout.n):
        raise ValueError(f"need an ({layout.n}, {layout.n}) matrix, got {tuple(a.shape)}")
    t = _tiles(a, layout)
    view = (layout.ltr, layout.nb, layout.ltc, layout.nb)
    out = [None] * (layout.p * layout.q)
    for m, r, c in _members(layout, mesh):
        s = torch.empty(layout.local_shape, dtype=a.dtype, device=mesh.devices[m])
        s.view(view).copy_(t[:, r, :, :, c, :])
        out[m] = s
    return out


def to_dense(shards, layout: BlockCyclicLayout, mesh: MemberMesh | None = None) -> torch.Tensor:
    """Inverse of :func:`from_dense`: the dense matrix, on the first member's
    device (the JAX function gathers it to the host), each shard copied
    there from its own card. On a ``mesh`` across processes, every process's
    shards reach every process first, by broadcast in member order, and each
    gets the whole matrix."""
    x = _check_shards(shards, layout, mesh)
    ref = x[_members(layout, mesh)[0][0]]
    out = torch.empty((layout.n, layout.n), dtype=ref.dtype, device=ref.device)
    t = _tiles(out, layout)
    view = (layout.ltr, layout.nb, layout.ltc, layout.nb)
    for m in range(layout.p * layout.q):
        r, c = divmod(m, layout.q)
        t[:, r, :, :, c, :].copy_(comm.share(x[m], m, layout.local_shape, ref.dtype, mesh)
                                  .view(view))
    return out


def _global_index(local_tiles: int, procs: int, proc: int, nb: int, device) -> torch.Tensor:
    """Global element indices of one member's local rows (or columns)."""
    tiles = torch.arange(local_tiles, dtype=torch.int64, device=device) * procs + proc
    return (tiles[:, None] * nb + torch.arange(nb, dtype=torch.int64, device=device)).reshape(-1)


def generate_spd_block_cyclic(
    layout: BlockCyclicLayout,
    mesh: MemberMesh,
    *,
    seed: int = 51,
    bump: float | None = None,
    dtype: torch.dtype = torch.float32,
) -> list[torch.Tensor]:
    """Distributed seeded SPD generation: every member materializes only its
    own tiles through the tile-local deterministic generator
    (``ops.lapack_like.plgsy_at``, the body of ``plgsy_tile``), in row slabs —
    the replacement for the reference client building the full N×N in RAM
    and uploading tile blobs one by one (``client_distrib.cpp:402-432``). The
    assembled matrix is ``plgsy``'s, bit for bit. On a mesh across processes
    a process makes its own members' shards only (None for the others)."""
    if bump is None:
        bump = float(layout.n)
    nb, ltr, ltc, p, q = layout.nb, layout.ltr, layout.ltc, layout.p, layout.q
    slab = max(1, _SLAB_ELEMS // (ltc * nb))
    out = [None] * (p * q)
    for m, r, c in _members(layout, mesh):
        dev = mesh.devices[m]
        with comm.on(dev):
            rows = _global_index(ltr, p, r, nb, dev)
            cols = _global_index(ltc, q, c, nb, dev)
            x = torch.empty(layout.local_shape, dtype=dtype, device=dev)
            for r0 in range(0, ltr * nb, slab):
                x[r0 : r0 + slab] = plgsy_at(seed, rows[r0 : r0 + slab], cols, bump=bump,
                                             dtype=dtype)
        out[m] = x
    return out
