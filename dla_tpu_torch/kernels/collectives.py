"""The ring collectives — counterparts of ``dla_tpu/kernels/collectives.py``:
:func:`ring_broadcast` (``:166``) and :func:`ring_all_gather` (``:223``), on a
flat mesh of D members, on one device or spread over the cards of one host.

In the JAX package each device of a ``shard_map`` runs the Pallas kernel on its
own block and the kernel's steps are remote DMAs between chips. Here a member
is a set of allocations of its own, on its own device, and a collective takes
the list of the D members' blocks (member d's block is what JAX places on
device d) and returns the list of their outputs, each on its member's device.
Data crosses between members only through the ring:

- on CUDA tensors each call is one cooperative launch of the hand-written
  Hopper kernel ``csrc/ring.cu`` per card that holds members taking part
  (:func:`card_launches`), all enqueued by one call into the library; every
  hop writes straight into the receiving member's output, through a peer
  pointer over NVLink where the receiver lies on another card, block by
  block in segments (:func:`ring_plan`);
- on CPU tensors the ``*_plain`` versions simulate the Pallas protocol step
  by step in torch, with per-member comm slots and the same capture
  arithmetic (not a bare copy, so that the arithmetic itself is tested
  against JAX's).

Members on the CPU and on a card at once, or on any other kind of device,
raise ``ValueError``; two cards that a hop joins but that cannot reach each
other's memory raise ``RuntimeError`` naming them (no staging through the
host). ``ring_broadcast_launches`` and ``ring_all_gather_launches`` count the
collectives that launched the kernel (one per call, whatever the cards), and
nothing else.

Each card holds one flag buffer that is never cleared, and every launch of the
process compares against one epoch (flags of a launch across cards lie on
several cards). A card's part runs on its current stream. Across cards the
parts order themselves on the devices (``csrc/ring.cu``'s header): a sender
writes into another card's output only after that card's stream has reached
the collective, and each card's part ends only when its bytes have landed; so
no card reads an output before its bytes have landed, no hop writes into
memory that the receiver's caching allocator may still hand to earlier work,
and no late flag of one launch reaches the next. A call looks its launch
record up by its cards, size, kind, group and root (:func:`_record`, made at
the first call), so a repeated call only fills in the pointers, the streams
and the epoch; the record is not shared between threads.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from dla_tpu_torch.kernels import _build

#: number of times each CUDA kernel was launched in this process
ring_broadcast_launches = 0
ring_all_gather_launches = 0

#: most members one launch takes (``kMaxMembers`` of ``csrc/ring.cu``, whose
#: pointer table fits the 4 KB of kernel parameters), and the most cards
#: (``kMaxDevices``: the flag buffers travel by device index)
MAX_MEMBERS = 128
MAX_DEVICES = 64

# a card's flag buffer (``csrc/ring.cu``): member d's row of data flags at
# d·blocks in the first _DATA_WORDS, then one ready word per (card, member)
_DATA_WORDS = 1 << 16
_FLAG_WORDS = _DATA_WORDS + MAX_DEVICES * MAX_MEMBERS
_flags: dict[torch.device, torch.Tensor] = {}  # card -> its flag buffer
_epoch = [0]  # the next launch's base, one for every card of the process
_peers: set[tuple[int, int]] = set()  # (from, to) cards whose peer access is on
_records: dict = {}  # (cards, bytes, kind, group, root, blocks, cut) -> _Record

#: how a launch cuts its work (:func:`ring_plan`): blocks per SM it aims at
#: and the fewest bytes a block copies between two flags; on one card, and
#: across cards over NVLink the fastest of the cuts that
#: ``bench/calibrate_model.py --only nvlink`` times (PERF.md, the NVLink fit)
CUT = dict(blocks_per_sm=2, min_segment=32 * 1024)
NVLINK_CUT = dict(blocks_per_sm=1, min_segment=32 * 1024)


class RingPlan(NamedTuple):
    """How one launch of ``csrc/ring.cu`` cuts its work. Each member that
    takes part runs ``blocks`` thread blocks; block b owns the bytes
    ``[b·stripe, (b+1)·stripe)`` of the member block (and of every block it
    forwards) and walks them in segments of ``segment`` bytes, raising its
    right neighbour's flag after each. A sender copies ``units`` member
    blocks (group − 1 for the all-gather: its own, then those it forwards;
    1 for the broadcast); ``steps`` = units·⌈stripe/segment⌉, the most flags
    one block raises, is how far the launch moves the epoch."""

    blocks: int
    stripe: int
    segment: int
    units: int
    steps: int


def _round16(n: int) -> int:
    return (n + 15) & ~15


def ring_plan(*, gather: bool, group: int, block_bytes: int, sms: int, per_card: int,
              blocks: int = 0, blocks_per_sm: float = 2,
              min_segment: int = 32 * 1024) -> RingPlan:
    """The cut of one collective over members of ``block_bytes`` each, on
    cards of ``sms`` SMs, whose busiest card launches ``per_card`` members;
    ``blocks`` > 0 fixes the blocks per member.

    Blocks: about ``blocks_per_sm``·sms on the busiest card, but no block
    with less than ``min_segment`` bytes of the member block. Segments: the
    block's slice cut into as many equal pieces of at least ``min_segment``
    bytes as fit (one if none do), each a multiple of 16 bytes so that the
    16-byte copies stay aligned."""
    if blocks <= 0:
        blocks = max(1, min(math.ceil(blocks_per_sm * sms / per_card),
                            -(-block_bytes // min_segment)))
    stripe = _round16(-(-block_bytes // blocks))
    nseg = max(1, stripe // min_segment)
    segment = _round16(-(-stripe // nseg))
    units = max(group - 1, 1) if gather else 1
    return RingPlan(blocks, stripe, segment, units, units * -(-stripe // segment))


def member_roles(d: int, *, gather: bool, group: int, root: int) -> tuple[bool, bool]:
    """(sends, receives) of member d: it sends into its right neighbour's
    output (or, in a sub-ring of one, its own) unless it is the last member
    of a broadcast's sub-ring; it receives from its left neighbour unless it
    is a broadcast's root or alone in its sub-ring."""
    dist = d % group if gather else (d % group - root) % group
    return (gather or group == 1 or dist != group - 1,
            group > 1 and (gather or dist != 0))


def right_of(d: int, group: int) -> int:
    """Member d's right neighbour in its sub-ring."""
    return d // group * group + (d % group + 1) % group


def left_of(d: int, group: int) -> int:
    """Member d's left neighbour in its sub-ring."""
    return d // group * group + (d % group - 1) % group


def card_launches(*, gather: bool, ndev: int, group: int, root: int,
                  cards) -> list[tuple[object, tuple[int, ...]]]:
    """The launches of one collective: [(card, its members)], one entry per
    card that holds members taking part, in ring order from the root (by
    their members' distance from it, then sub-ring: the order in which the
    data reaches them, so a part is enqueued before the bytes that it waits
    for can arrive); ``cards[d]`` is member d's card (any hashable label). A
    member takes part if it sends, or if it receives from a member on
    another card (the last member of a broadcast then only waits for its
    bytes)."""
    out: dict = {}
    for d in sorted(range(ndev), key=lambda d: ((d % group - root) % group, d)):
        sends, receives = member_roles(d, gather=gather, group=group, root=root)
        if sends or (receives and cards[left_of(d, group)] != cards[d]):
            out.setdefault(cards[d], []).append(d)
    return [(card, tuple(ms)) for card, ms in out.items()]


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
    """True for members all on the CPU, False for members all on CUDA cards;
    raises ``ValueError`` for a mix or any other device."""
    types = {x.device.type for x in xs}
    if types == {"cpu"}:
        return True
    if types != {"cuda"}:
        raise ValueError(f"{name} needs its members all on the CPU or all on CUDA cards; got "
                         f"{sorted({str(x.device) for x in xs})}")
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
    fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3
                   + [ctypes.c_ulonglong, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _entry():
    """``dla_ring_launch`` of ``csrc/ring.cu``."""
    return _bind(_build.load().dla_ring_launch)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _new_flags(dev: torch.device) -> torch.Tensor:
    """A flag buffer for the ring launches on card ``dev``."""
    return torch.zeros(_FLAG_WORDS, dtype=torch.int64, device=dev)


def _peer_access(a: int, b: int) -> bool:
    """Whether card ``a`` can reach card ``b``'s memory."""
    return torch.cuda.can_device_access_peer(a, b)


def _enable_peers(pairs) -> None:
    """Peer access for each (from, to) pair of cards, once per pair and
    process; raises naming a pair that cannot reach each other."""
    for pair in pairs:
        if pair in _peers:
            continue
        if not _peer_access(*pair):
            raise RuntimeError(f"the ring needs card {pair[0]} to write card {pair[1]}'s "
                               "memory, and it cannot reach it (no peer access): there is no "
                               "staging through the host")
        err = _build.load().dla_ring_enable_peer(*pair)
        if err != 0:
            raise RuntimeError(f"the ring needs card {pair[0]} to write card {pair[1]}'s memory "
                               f"over NVLink, and peer access between them failed (CUDA error "
                               f"{err}); there is no staging through the host")
        _peers.add(pair)


class _Record(NamedTuple):
    """What every call of one collective shape passes to ``dla_ring_launch``
    but its pointers, streams and epoch: the plan, the parts, each member's
    card, the flag buffers by device index, and the ctypes arrays that a call
    fills in (``xp``, ``op``, ``streams``)."""

    head: tuple  # (gather, ndev, group, root)
    plan: RingPlan
    block_bytes: int
    cards: list  # the parts' cards, torch devices, in launch order
    pairs: frozenset  # (from, to) cards that a hop joins, both ways
    sys: int
    args: tuple  # the ctypes arrays: cards, flags, part_card, part_size, members
    xp: object
    op: object
    streams: object


def _record(cards, block_bytes: int, *, gather: bool, group: int, root: int, blocks: int = 0,
            cut: dict | None = None, flags: dict | None = None) -> _Record:
    """The launch record of one collective over members on ``cards`` (torch
    devices, one a member) of ``block_bytes`` each, cut by ``cut`` (default
    :data:`CUT` on one card, :data:`NVLINK_CUT` across cards) with ``blocks``
    thread blocks a member (0: the plan's); ``flags`` (card -> buffer, made
    at first use, default this process's) holds the flags."""
    flags = _flags if flags is None else flags
    ndev = len(cards)
    spans = len(set(cards)) > 1
    cut = dict(NVLINK_CUT if spans else CUT) if cut is None else cut
    launches = card_launches(gather=gather, ndev=ndev, group=group, root=root, cards=cards)
    plan = ring_plan(gather=gather, group=group, block_bytes=block_bytes,
                     sms=_sms(cards[0].index), blocks=blocks,
                     per_card=max(len(ms) for _, ms in launches), **cut)
    if ndev * plan.blocks > _DATA_WORDS:
        raise ValueError(f"{ndev} members x {plan.blocks} blocks need more than the "
                         f"{_DATA_WORDS} ring flags of a card")
    if any(c.index >= MAX_DEVICES for c in cards):
        raise ValueError(f"the ring takes cards 0 to {MAX_DEVICES - 1}; got {sorted(set(cards))}")
    table = (ctypes.c_void_p * MAX_DEVICES)()
    for card in cards:
        if card not in flags:
            flags[card] = _new_flags(card)
        table[card.index] = flags[card].data_ptr()
    # a hop writes its receiver's card; the receiver's ready word, its sender's card
    hops = {(cards[d].index, cards[right_of(d, group)].index) for d in range(ndev)
            if cards[d] != cards[right_of(d, group)]}
    pairs = frozenset(hops | {(b, a) for a, b in hops})
    members = [m for _, ms in launches for m in ms]
    ints = lambda v: (ctypes.c_int * len(v))(*v)  # noqa: E731
    args = (ints([c.index for c in cards]), table, ints([c.index for c, _ in launches]),
            ints([len(ms) for _, ms in launches]), ints(members))
    return _Record((int(gather), ndev, group, root), plan, block_bytes,
                   [c for c, _ in launches], pairs, int(spans), args,
                   (ctypes.c_void_p * ndev)(), (ctypes.c_void_p * ndev)(),
                   (ctypes.c_void_p * len(launches))())


def _call(fn, rec: _Record, xs, outs) -> int:
    """One collective of ``fn`` (:func:`_bind`) over the members ``xs`` into
    ``outs`` by the record ``rec``: every card's part on that card's current
    stream, on the process's epoch; the CUDA error, 0 when every part
    launched. The epoch then lies above every flag that the launch raises."""
    rec.xp[:] = [x.data_ptr() for x in xs]
    rec.op[:] = [o.data_ptr() for o in outs]
    rec.streams[:] = [torch.cuda.current_stream(c).cuda_stream for c in rec.cards]
    cards, table, part_card, part_size, members = rec.args
    gather, ndev, group, root = rec.head
    plan = rec.plan
    err = fn(gather, ndev, group, root, rec.xp, rec.op, cards, table, rec.block_bytes,
             plan.stripe, plan.segment, _epoch[0], plan.blocks, len(rec.cards), part_card,
             part_size, members, rec.streams, rec.sys)
    if err == 0:
        _epoch[0] += plan.steps
    return err


def _launch(name: str, xs, outs, *, gather: bool, group: int, root: int, blocks: int = 0,
            cut: dict | None = None) -> None:
    """One collective of ``csrc/ring.cu`` over the members ``xs`` into
    ``outs``, by the launch record of its shape (made at its first call);
    ``blocks`` thread blocks per member, 0 for the plan's; ``cut`` a cut of
    :func:`ring_plan`, by default :data:`CUT` or :data:`NVLINK_CUT`. It
    allocates nothing but, once per card, the flags."""
    ndev = len(xs)
    if ndev > MAX_MEMBERS:
        raise ValueError(f"{name} on CUDA devices takes at most {MAX_MEMBERS} members (the "
                         f"kernel's pointer table in its 4 KB of parameters); got {ndev}")
    read = xs if gather else xs[root::group]
    if any(not x.is_contiguous() for x in read) or any(not o.is_contiguous() for o in outs):
        raise ValueError(f"{name} needs contiguous member blocks on a CUDA device")
    cards = tuple(x.device for x in xs)
    block_bytes = xs[0].numel() * xs[0].element_size()
    key = (cards, block_bytes, gather, group, root, blocks,
           None if cut is None else tuple(sorted(cut.items())))
    rec = _records.get(key)
    if rec is None:
        rec = _record(cards, block_bytes, gather=gather, group=group, root=root, blocks=blocks,
                      cut=cut)
        if len(_records) >= 512:
            _records.clear()
        _records[key] = rec
    if not rec.pairs <= _peers:
        _enable_peers(sorted(rec.pairs))
    err = _call(_entry(), rec, xs, outs)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}"
                           + (" (the members' blocks cannot all be resident at once)"
                              if err == 720 else ""))


def ring_broadcast(xs, root: int, *, group: int | None = None,
                   chunks: int | None = None) -> list[torch.Tensor]:
    """Broadcast each sub-ring's ``root`` member block (m, n) to every member
    of that sub-ring by pipelined forwarding; returns the D outputs, new
    tensors. ``xs`` is the list of the D member blocks, of one shape and
    dtype; non-root contents are ignored (JAX's non-owners pass zeros), and
    on a card only the roots' blocks need be contiguous (the others may be
    expanded views: only their card counts). ``root`` is the group-local
    index (taken modulo ``group``, as JAX's ring distance does). ``group``
    (default: D) runs independent sub-rings of that size, member id =
    r·group + c; ``chunks`` (default :func:`broadcast_chunks`) splits the
    block into row chunks so that the hops pipeline, C + group − 2 steps of
    the plain version (the kernel pipelines its own segments,
    :func:`ring_plan`). The reference's errors for a block that is not 2-D, a
    group that does not divide D, or chunks that do not divide m."""
    global ring_broadcast_launches
    ndev, m, group, root, chunks = _bcast_args(xs, root, group, chunks)
    if _on_cpu("ring_broadcast", xs):
        return ring_broadcast_plain(xs, root, group=group, chunks=chunks)
    outs = [torch.empty(x.shape, dtype=x.dtype, device=x.device) for x in xs]
    if xs[0].numel() == 0:
        return outs
    _launch("ring_broadcast", xs, outs, gather=False, group=group, root=root)
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
    _launch("ring_all_gather", xs, outs, gather=True, group=group, root=0)
    ring_all_gather_launches += 1
    return outs
