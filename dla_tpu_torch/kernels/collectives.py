"""The ring collectives — counterparts of ``dla_tpu/kernels/collectives.py``:
:func:`ring_broadcast` (``:166``) and :func:`ring_all_gather` (``:223``), on a
flat mesh of D members that share one device.

In the JAX package each device of a ``shard_map`` runs the Pallas kernel on its
own block and the kernel's steps are remote DMAs between chips. Here a member
is a set of allocations of its own, and a collective takes the list of the D
members' blocks (member d's block is what JAX places on device d) and returns
the list of their outputs. Data crosses between members only through the ring:

- on CUDA tensors (all on one device) each call is one cooperative launch of
  the hand-written Hopper kernel ``csrc/ring.cu``, in which every hop writes
  straight into the receiving member's output (:func:`ring_plan` sets its
  pipeline);
- on CPU tensors the ``*_plain`` versions simulate the Pallas protocol step
  by step in torch, with per-member comm slots and the same capture
  arithmetic (not a bare copy, so that the arithmetic itself is tested
  against JAX's).

Members on the CPU and on a card at once raise ``ValueError``; members on
several cards raise ``NotImplementedError`` (ROADMAP A9: members on several
cards). ``ring_broadcast_launches`` and ``ring_all_gather_launches`` count the
kernel's launches, and nothing else.

Launches on one device share a flag buffer that is never cleared (each launch
compares against an epoch of its own), so they must run in order, on one
stream, as every caller of this package does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from dla_tpu_torch.kernels import _build

#: number of times each CUDA kernel was launched in this process
ring_broadcast_launches = 0
ring_all_gather_launches = 0

#: most members one launch takes (``kMaxMembers`` of ``csrc/ring.cu``, whose
#: pointer table fits the 4 KB of kernel parameters)
MAX_MEMBERS = 128

_FLAG_WORDS = 1 << 13  # 64-bit flags per device; the card holds fewer resident blocks
_flags: dict[torch.device, list] = {}  # device -> [flag tensor, next epoch]

#: sender blocks per SM a launch aims at, and the fewest bytes a block copies
#: between two flags (``csrc/ring.cu``'s header says why)
BLOCKS_PER_SM = 2
MIN_SEGMENT = 32 * 1024


class RingPlan(NamedTuple):
    """How one launch of ``csrc/ring.cu`` cuts its work. ``senders`` members
    copy (every member for the all-gather; all but the last of each sub-ring
    for the broadcast, and every member of a sub-ring of one), each with
    ``blocks`` thread blocks. A sender copies ``units`` units of
    ``unit_bytes``, block b the bytes ``[b·stripe, (b+1)·stripe)`` of each, and
    after each unit that its right neighbour forwards it raises that
    neighbour's flag of block b by one."""

    senders: int
    blocks: int
    units: int
    unit_bytes: int
    stripe: int


def ring_plan(*, gather: bool, ndev: int, group: int, chunks: int, block_bytes: int,
              sms: int, blocks: int = 0) -> RingPlan:
    """The cut of one launch over ``ndev`` members of ``block_bytes`` each, on
    a card of ``sms`` SMs; ``blocks`` > 0 fixes the blocks per sender.

    Blocks: about BLOCKS_PER_SM·sms sender blocks in all, but no block with
    less than MIN_SEGMENT bytes of the member's block. Units: the
    all-gather's unit is one member block, and a sender copies group − 1 of
    them (its own, then those it forwards); the broadcast's unit is the
    fewest of the caller's ``chunks`` that give each block MIN_SEGMENT bytes
    (all of them if none do), so that a short pipeline carries few flags."""
    per_ring = group if gather or group == 1 else group - 1
    senders = ndev // group * per_ring
    if blocks <= 0:
        blocks = max(1, min(-(-BLOCKS_PER_SM * sms // senders), -(-block_bytes // MIN_SEGMENT)))
    if gather:
        units, unit_bytes = max(group - 1, 1), block_bytes
    else:
        chunk_bytes = block_bytes // chunks
        k = next((k for k in range(1, chunks + 1)
                  if chunks % k == 0 and k * chunk_bytes >= blocks * MIN_SEGMENT), chunks)
        units, unit_bytes = chunks // k, k * chunk_bytes
    stripe = (-(-unit_bytes // blocks) + 15) & ~15  # a multiple of 16: 16-byte copies stay aligned
    return RingPlan(senders, blocks, units, unit_bytes, stripe)


def broadcast_chunks(m: int, group: int) -> int:
    """Pipeline chunk count :func:`ring_broadcast` uses for an ``m``-row
    buffer on a ``group``-device ring (and that the scaling model charges —
    ``parallel/model.py`` imports this so the projected time law and the
    implemented kernel cannot drift apart).

    The store-and-forward cost of an unchunked ring broadcast is
    ``(D−1)·(V/bw + lat)``; splitting into C chunks pipelines the hops to
    ``(C + D − 2)·(V/(C·bw) + lat)`` → ``V/bw`` for large C. Picks the
    largest C ≤ 16·(D−1) (bandwidth overhead (D−2)/C ≤ ~6%; near the
    optimal C* = √((D−2)·V/(bw·lat)) ≈ 70 for an nb=4096 f32 tile on a
    v5e link) that divides ``m`` into sublane-aligned chunks
    (rows % 16 == 0 covers f32 and bf16 tiling); 1 when the buffer is too
    small to split (≤ one tile of rows), which degenerates to exactly the
    pre-chunking kernel."""
    if group <= 1:
        return 1
    for c in range(min(16 * (group - 1), m // 16), 0, -1):
        if m % c == 0 and (m // c) % 16 == 0:
            return c
    return 1


def _members(name: str, xs) -> tuple[int, int, int]:
    """(D, m, n) of the member blocks; the reference's 2-D check, plus one
    shape and dtype for all members."""
    xs = list(xs)
    if not xs:
        raise ValueError(f"{name} needs at least one member block")
    for x in xs:
        if x.ndim != 2:
            raise ValueError(f"{name} expects a 2-D block, got {tuple(x.shape)}")
    if any(x.shape != xs[0].shape or x.dtype != xs[0].dtype for x in xs):
        raise ValueError(f"{name} needs one shape and dtype for every member; got "
                         f"{[(tuple(x.shape), x.dtype) for x in xs]}")
    return len(xs), xs[0].shape[0], xs[0].shape[1]


def _group(ndev: int, group: int | None) -> int:
    group = ndev if group is None else group
    if group < 1 or ndev % group:
        raise ValueError(f"axis size {ndev} not a multiple of group {group}")
    return group


def _bcast_args(xs, root: int, group: int | None, chunks: int | None):
    """The reference's checks (``collectives.py:188-200``): (D, m, group,
    root within its sub-ring, chunks)."""
    ndev, m, _ = _members("ring_broadcast", xs)
    group = _group(ndev, group)
    if chunks is None:
        chunks = broadcast_chunks(m, group)
    if chunks < 1 or m % chunks:
        raise ValueError(f"chunks={chunks} must divide the {m} buffer rows")
    return ndev, m, group, int(root) % group, chunks


def _on_cpu(name: str, xs) -> bool:
    """True for members all on the CPU; raises unless they all lie on one
    CUDA device otherwise."""
    devs = {x.device for x in xs}
    if all(d.type == "cpu" for d in devs):
        return True
    if any(d.type != "cuda" for d in devs):
        raise ValueError(f"{name} needs its members all on the CPU or all on one CUDA device; "
                         f"got {sorted(str(d) for d in devs)}")
    if len(devs) > 1:
        raise NotImplementedError(
            f"{name}: members on several cards ({sorted(str(d) for d in devs)}) are not "
            "supported yet (ROADMAP A9: members on several cards, peer pointers)")
    return False


def ring_broadcast_plain(xs, root: int, *, group: int | None = None,
                         chunks: int | None = None) -> list[torch.Tensor]:
    """The plain torch version of :func:`ring_broadcast`: the Pallas protocol
    (``_bcast_kernel``, ``collectives.py:109-163``) step by step, with two comm
    slots per member."""
    ndev, m, group, root, chunks = _bcast_args(xs, root, group, chunks)
    mc = m // chunks
    outs = [x.clone() for x in xs]
    comm = [x.new_empty((2, mc, x.shape[1])) for x in xs]
    for d in range(ndev):
        comm[d][0] = xs[d][:mc]
    for t in range(chunks + group - 2):
        sslot, rslot = t % 2, (t + 1) % 2
        for d in range(ndev):
            if (d % group - root) % group == 0 and t > 0:
                ci = min(t, chunks - 1)
                comm[d][sslot] = xs[d][ci * mc : (ci + 1) * mc]
        for d in range(ndev):  # each member sends slot t % 2 to its right neighbour's other slot
            right = (d // group) * group + (d % group + 1) % group
            comm[right][rslot] = comm[d][sslot]
        for d in range(ndev):
            dist = (d % group - root) % group
            cap = t - (dist - 1)
            if dist != 0 and 0 <= cap < chunks:
                outs[d][cap * mc : (cap + 1) * mc] = comm[d][rslot]
    return outs


def ring_all_gather_plain(xs, *, group: int | None = None) -> list[torch.Tensor]:
    """The plain torch version of :func:`ring_all_gather`: the Pallas protocol
    (``_ring_kernel``, ``collectives.py:52-83``) step by step, with two comm
    slots per member."""
    ndev, m, n = _members("ring_all_gather", xs)
    group = _group(ndev, group)
    outs = [x.new_empty((group * m, n)) for x in xs]
    comm = [x.new_empty((2, m, n)) for x in xs]
    for d in range(ndev):
        c = d % group
        outs[d][c * m : (c + 1) * m] = xs[d]
        comm[d][0] = xs[d]
    for step in range(group - 1):
        sslot, rslot = step % 2, (step + 1) % 2
        for d in range(ndev):
            right = (d // group) * group + (d % group + 1) % group
            comm[right][rslot] = comm[d][sslot]
        for d in range(ndev):
            src = (d % group - step - 1) % group
            outs[d][src * m : (src + 1) * m] = comm[d][rslot]
    return outs


def _bind(fn):
    """``fn``, the ``dla_ring_launch`` of a build of ``csrc/ring.cu``, with its
    C signature."""
    fn.argtypes = ([ctypes.c_int] * 6 + [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4
                   + [ctypes.c_ulonglong, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _entry():
    """``dla_ring_launch`` of ``csrc/ring.cu``."""
    return _bind(_build.load().dla_ring_launch)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _new_flags(dev: torch.device) -> list:
    """[flag buffer, next epoch] for launches on ``dev`` that share one stream."""
    return [torch.zeros(_FLAG_WORDS, dtype=torch.int64, device=dev), 0]


def _call(fn, flags: list, xs, outs, *, gather: bool, group: int, root: int,
         plan: RingPlan) -> int:
    """One launch of ``fn`` (:func:`_bind`) over the members ``xs`` into
    ``outs``, cut by ``plan``, on the flags and epoch ``flags``
    (:func:`_new_flags`), on the current stream; the CUDA error, 0 when it
    launched. The epoch then lies above every flag that the launch raises."""
    ndev = len(xs)
    dev = xs[0].device
    ptrs = ctypes.c_void_p * ndev
    with torch.cuda.device(dev):
        err = fn(int(gather), ndev, group, root, plan.senders, plan.units,
                 ptrs(*(x.data_ptr() for x in xs)), ptrs(*(o.data_ptr() for o in outs)),
                 flags[0].data_ptr(), _FLAG_WORDS, xs[0].numel() * xs[0].element_size(),
                 plan.unit_bytes, plan.stripe, flags[1], plan.blocks,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err == 0:
        flags[1] += plan.units
    return err


def _launch(name: str, xs, outs, *, gather: bool, group: int, root: int, chunks: int,
            blocks: int = 0) -> None:
    """One cooperative launch of ``csrc/ring.cu`` over the members ``xs`` into
    ``outs``, cut by :func:`ring_plan`; ``blocks`` thread blocks per sender,
    0 for the plan's choice. It allocates nothing but, once per device, the
    flags."""
    ndev = len(xs)
    if ndev > MAX_MEMBERS:
        raise ValueError(f"{name} on a CUDA device takes at most {MAX_MEMBERS} members (the "
                         f"kernel's pointer table in its 4 KB of parameters); got {ndev}")
    if any(not x.is_contiguous() for x in xs):
        raise ValueError(f"{name} needs contiguous member blocks on a CUDA device")
    dev = xs[0].device
    plan = ring_plan(gather=gather, ndev=ndev, group=group, chunks=chunks,
                     block_bytes=xs[0].numel() * xs[0].element_size(), sms=_sms(dev.index),
                     blocks=blocks)
    flags = _flags.get(dev)
    if flags is None:
        flags = _flags[dev] = _new_flags(dev)
    err = _call(_entry(), flags, xs, outs, gather=gather, group=group, root=root, plan=plan)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}"
                           + (" (the members' blocks cannot all be resident at once)"
                              if err == 720 else ""))


def ring_broadcast(xs, root: int, *, group: int | None = None,
                   chunks: int | None = None) -> list[torch.Tensor]:
    """Broadcast each sub-ring's ``root`` member block (m, n) to every member
    of that sub-ring by chunk-pipelined forwarding; returns the D outputs,
    new tensors. ``xs`` is the list of the D member blocks, of one shape and
    dtype; non-root contents are ignored (JAX's non-owners pass zeros).
    ``root`` is the group-local index (taken modulo ``group``, as JAX's ring
    distance does). ``group`` (default: D) runs independent sub-rings of that
    size, member id = r·group + c; ``chunks`` (default :func:`broadcast_chunks`)
    splits the block into row chunks so that the hops pipeline, C + group − 2
    steps of the plain version (the kernel pipelines whole numbers of them,
    :func:`ring_plan`). The reference's errors for a block that is not 2-D, a
    group that does not divide D, or chunks that do not divide m."""
    global ring_broadcast_launches
    ndev, m, group, root, chunks = _bcast_args(xs, root, group, chunks)
    if _on_cpu("ring_broadcast", xs):
        return ring_broadcast_plain(xs, root, group=group, chunks=chunks)
    outs = [torch.empty_like(x, memory_format=torch.contiguous_format) for x in xs]
    if xs[0].numel() == 0:
        return outs
    _launch("ring_broadcast", xs, outs, gather=False, group=group, root=root, chunks=chunks)
    ring_broadcast_launches += 1
    return outs


def ring_all_gather(xs, *, group: int | None = None) -> list[torch.Tensor]:
    """All-gather along the flat mesh by a one-way ring: member d's output is
    its sub-ring's blocks stacked in member order, (group·m, n), new tensors —
    ``lax.all_gather(x, tiled=True)`` with ``axis_index_groups`` of consecutive
    members. ``group`` (default: D) must divide D."""
    global ring_all_gather_launches
    ndev, m, n = _members("ring_all_gather", xs)
    group = _group(ndev, group)
    if _on_cpu("ring_all_gather", xs):
        return ring_all_gather_plain(xs, group=group)
    outs = [x.new_empty((group * m, n)) for x in xs]
    if xs[0].numel() == 0:
        return outs
    _launch("ring_all_gather", xs, outs, gather=True, group=group, root=0, chunks=1)
    ring_all_gather_launches += 1
    return outs
