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
  Hopper kernel ``csrc/ring.cu`` per card that holds senders
  (:func:`card_launches`), all enqueued back to back; every hop writes
  straight into the receiving member's output, through a peer pointer over
  NVLink where the receiver lies on another card (:func:`ring_plan` sets the
  pipeline);
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
several cards). A card's launches run on its current stream. Where a ring
spans cards, each card's launch first waits for the earlier work of every card
that it writes into, and each card then waits for every launch that wrote into
it: no card reads an output before its bytes have landed (the last member of
a broadcast launches nothing of its own), no launch writes into memory that
its card's caching allocator may still hand to earlier work, and no late flag
of one launch reaches the next.
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

_FLAG_WORDS = 1 << 16  # 64-bit flags per card: a row of blocks per member index
_flags: dict[torch.device, torch.Tensor] = {}  # card -> its flag buffer
_epoch = [0]  # the next launch's base, one for every card of the process
_peers: set[tuple[int, int]] = set()  # (from, to) cards whose peer access is on

#: sender blocks per SM a launch aims at, and the fewest bytes a block copies
#: between two flags (``csrc/ring.cu``'s header says why): on one card, and
#: across cards over NVLink, the fastest of the cuts that
#: ``bench/calibrate_model.py --only nvlink`` times (PERF.md, the NVLink fit)
BLOCKS_PER_SM = 2
MIN_SEGMENT = 32 * 1024
NVLINK_BLOCKS_PER_SM = 1
NVLINK_MIN_SEGMENT = 128 * 1024


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
              sms: int, blocks: int = 0, per_card: int | None = None,
              blocks_per_sm: int | None = None, min_segment: int | None = None) -> RingPlan:
    """The cut of one collective over ``ndev`` members of ``block_bytes``
    each, on cards of ``sms`` SMs, whose busiest card launches ``per_card``
    senders (default: all of them, one card); ``blocks`` > 0 fixes the blocks
    per sender.

    Blocks: about ``blocks_per_sm``·sms sender blocks on the busiest card
    (default BLOCKS_PER_SM), but no block with less than ``min_segment``
    bytes of the member's block (default MIN_SEGMENT). Units: the
    all-gather's unit is one member block, and a sender copies group − 1 of
    them (its own, then those it forwards); the broadcast's unit is the
    fewest of the caller's ``chunks`` that give each block ``min_segment``
    bytes (all of them if none do), so that a short pipeline carries few
    flags."""
    bps = BLOCKS_PER_SM if blocks_per_sm is None else blocks_per_sm
    seg = MIN_SEGMENT if min_segment is None else min_segment
    per_ring = group if gather or group == 1 else group - 1
    senders = ndev // group * per_ring
    per_card = senders if per_card is None else per_card
    if blocks <= 0:
        blocks = max(1, min(-(-bps * sms // per_card), -(-block_bytes // seg)))
    if gather:
        units, unit_bytes = max(group - 1, 1), block_bytes
    else:
        chunk_bytes = block_bytes // chunks
        k = next((k for k in range(1, chunks + 1)
                  if chunks % k == 0 and k * chunk_bytes >= blocks * seg), chunks)
        units, unit_bytes = chunks // k, k * chunk_bytes
    stripe = (-(-unit_bytes // blocks) + 15) & ~15  # a multiple of 16: 16-byte copies stay aligned
    return RingPlan(senders, blocks, units, unit_bytes, stripe)


def sender_member(w: int, *, gather: bool, group: int, root: int, per_ring: int) -> int:
    """The member that sender ``w`` (r·per_ring + k) of a launch is: k is its
    distance from the root (broadcast) or its place c (all-gather)."""
    r, k = divmod(w, per_ring)
    return r * group + (k if gather else (root + k) % group)


def right_of(d: int, group: int) -> int:
    """Member d's right neighbour in its sub-ring."""
    return d // group * group + (d % group + 1) % group


def card_launches(*, gather: bool, ndev: int, group: int, root: int,
                  cards) -> list[tuple[object, tuple[int, ...]]]:
    """The launches of one collective: [(card, its senders)], one entry per
    card that holds senders, in the order of their first sender; ``cards[d]``
    is member d's card (any hashable label). A sender is r·per_ring + k, as
    :func:`sender_member` reads it."""
    per_ring = group if gather or group == 1 else group - 1
    out: dict = {}
    for w in range(ndev // group * per_ring):
        d = sender_member(w, gather=gather, group=group, root=root, per_ring=per_ring)
        out.setdefault(cards[d], []).append(w)
    return [(card, tuple(ws)) for card, ws in out.items()]


def card_writes(launches, *, gather: bool, group: int, root: int, cards) -> dict:
    """{card: the other cards whose members' outputs or flags its launch
    writes}: the cards of its senders' right neighbours, its own left out."""
    per_ring = group if gather or group == 1 else group - 1
    out = {}
    for card, ws in launches:
        dst = {cards[right_of(sender_member(w, gather=gather, group=group, root=root,
                                            per_ring=per_ring), group)] for w in ws}
        out[card] = sorted(dst - {card}, key=str)
    return out


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
    fn.argtypes = ([ctypes.c_int] * 6 + [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
                   + [ctypes.c_ulonglong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_void_p])
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


def _flag_rows(cards, blocks: int, flags: dict) -> list[int]:
    """Member d's row of ``blocks`` flags, in its own card's buffer of
    ``flags`` (made at first use), as a device pointer."""
    if len(cards) * blocks > _FLAG_WORDS:
        raise ValueError(f"{len(cards)} members x {blocks} blocks need more than the "
                         f"{_FLAG_WORDS} ring flags of a card")
    rows = []
    for d, card in enumerate(cards):
        buf = flags.get(card)
        if buf is None:
            buf = flags[card] = _new_flags(card)
        rows.append(buf.data_ptr() + 8 * d * blocks)
    return rows


def _peer_access(a: int, b: int) -> bool:
    """Whether card ``a`` can reach card ``b``'s memory."""
    return torch.cuda.can_device_access_peer(a, b)


def _enable_peers(cards, group: int) -> None:
    """Peer access from each member's card to its right neighbour's, once per
    pair and process; raises naming a pair that cannot reach each other."""
    for d, card in enumerate(cards):
        pair = (card.index, cards[right_of(d, group)].index)
        if pair[0] == pair[1] or pair in _peers:
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


def _call(fn, flags: dict, xs, outs, *, gather: bool, group: int, root: int,
          plan: RingPlan) -> int:
    """One collective of ``fn`` (:func:`_bind`) over the members ``xs`` into
    ``outs``, cut by ``plan``: one launch per card that holds senders, each
    on that card's current stream, on the flag buffers ``flags`` (card ->
    buffer, made at first use) and the process's epoch; the CUDA error, 0
    when every card launched. The epoch then lies above every flag that the
    launch raises. Where the ring spans cards, each card's launch waits for
    the earlier work of the cards it writes into, and those cards then wait
    for it."""
    ndev = len(xs)
    cards = [x.device for x in xs]
    spans = len(set(cards)) > 1
    per_ring = plan.senders // (ndev // group)
    launches = card_launches(gather=gather, ndev=ndev, group=group, root=root, cards=cards)
    ptrs = ctypes.c_void_p * ndev
    xp, op = ptrs(*(x.data_ptr() for x in xs)), ptrs(*(o.data_ptr() for o in outs))
    fp = ptrs(*_flag_rows(cards, plan.blocks, flags))
    writes = card_writes(launches, gather=gather, group=group, root=root, cards=cards) \
        if spans else {}
    if spans:
        ready = {}
        for card in {c for ws in writes.values() for c in ws}:
            ready[card] = torch.cuda.Event()
            ready[card].record(torch.cuda.current_stream(card))
        for card, dst in writes.items():
            for other in dst:
                torch.cuda.current_stream(card).wait_event(ready[other])
    block_bytes = xs[0].numel() * xs[0].element_size()
    for card, ws in launches:
        with torch.cuda.device(card):
            err = fn(int(gather), ndev, group, root, per_ring, plan.units, xp, op, fp,
                     block_bytes, plan.unit_bytes, plan.stripe, _epoch[0], plan.blocks, len(ws),
                     (ctypes.c_int * len(ws))(*ws), int(spans),
                     torch.cuda.current_stream(card).cuda_stream)
        if err != 0:
            return err
    _epoch[0] += plan.units
    for card, dst in writes.items():
        if dst:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(card))
            for other in dst:
                torch.cuda.current_stream(other).wait_event(done)
    return 0


@functools.cache
def _resident(index: int) -> int:
    """Ring blocks that card ``index`` holds at once (0: no cooperative launch)."""
    fn = _build.load().dla_ring_resident
    fn.restype = ctypes.c_longlong
    with torch.cuda.device(index):
        return int(fn())


def _launch(name: str, xs, outs, *, gather: bool, group: int, root: int, chunks: int,
            blocks: int = 0, cut: dict | None = None) -> None:
    """One collective of ``csrc/ring.cu`` over the members ``xs`` into
    ``outs``, cut by :func:`ring_plan` (``cut``: its ``blocks_per_sm`` and
    ``min_segment``, by default this module's for one card or across cards);
    ``blocks`` thread blocks per sender, 0 for the plan's choice. It
    allocates nothing but, once per card, the flags."""
    ndev = len(xs)
    if ndev > MAX_MEMBERS:
        raise ValueError(f"{name} on CUDA devices takes at most {MAX_MEMBERS} members (the "
                         f"kernel's pointer table in its 4 KB of parameters); got {ndev}")
    if any(not x.is_contiguous() for x in xs):
        raise ValueError(f"{name} needs contiguous member blocks on a CUDA device")
    cards = [x.device for x in xs]
    spans = len(set(cards)) > 1
    launches = card_launches(gather=gather, ndev=ndev, group=group, root=root, cards=cards)
    if cut is None:
        cut = (dict(blocks_per_sm=NVLINK_BLOCKS_PER_SM, min_segment=NVLINK_MIN_SEGMENT) if spans
               else {})
    plan = ring_plan(gather=gather, ndev=ndev, group=group, chunks=chunks,
                     block_bytes=xs[0].numel() * xs[0].element_size(), sms=_sms(cards[0].index),
                     blocks=blocks, per_card=max(len(ws) for _, ws in launches), **cut)
    # every card's part is checked before any launches: a part launched alone would spin
    for card, ws in launches:
        if len(ws) * plan.blocks > _resident(card.index):
            raise RuntimeError(f"{name} kernel launch failed: {len(ws)} senders x {plan.blocks} "
                               f"blocks on {card} (the members' blocks cannot all be resident "
                               "at once)")
    if spans:
        _enable_peers(cards, group)
    err = _call(_entry(), _flags, xs, outs, gather=gather, group=group, root=root, plan=plan)
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
