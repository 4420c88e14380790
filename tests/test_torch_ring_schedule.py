"""The schedule of the ring kernel ``csrc/ring.cu`` (``ring_broadcast`` and
``ring_all_gather``, on one card and across cards), written as torch byte
copies on the CPU and held to the bits of the plain versions.

The wrapper's own host path (``collectives._record`` and ``_call``) is driven
with a stand-in for ``dla_ring_launch`` that keeps its C arguments;
``_kernel_blocks`` then reads them as ``ring_kernel`` does and lists what
each thread block does, line for line: the ready word it raises, the flags
it waits on, the bytes it copies from where to where per segment, and the
flags it raises. ``_simulate`` runs each card's stream in order (earlier work,
the collective's part, a read queued after it, as a caller's next kernel)
and every started block in a seeded shuffled order that respects only the
flags (a block that waits on a flag not yet raised stays blocked), as the
cards may. The tests require

- the plain versions' bits in every member's output (and JAX's across cards);
- every output byte written exactly once, and every write into member d's
  output made by d itself or by its left neighbour in its sub-ring;
- every data wait on the waiting member's own flag, on its own card, which
  only its left neighbour raises: no data wait points rightward or at itself,
  so none deadlocks; every ready word raised first thing by its receiver;
- every byte a block forwards written before the flag raise that its last
  wait saw (the release/acquire pair of the kernel), in the writer's
  program order: read off the programs, not off one lucky order;
- no read of a non-root member's block (NaN-filled here);
- the bytes read and written: V + (group − 2)·V read, group·V written per
  sub-ring for the broadcast; (group − 1)·V read, group·V written per member
  for the all-gather;
- across cards: no write into an output before its card's stream has run
  the earlier work queued before the collective; every card's read after the
  collective sees all its bytes landed; no flag or ready word written by one
  launch while an earlier launch still has a write or a wait on it pending
  (so no late write of one launch lowers or fakes a flag of the next);
- flags never cleared: every wait of a launch above every flag that earlier
  launches left.

The planes' 15360 × 1024 fp64 panel is checked in metadata only (intervals,
no data).
"""

import bisect
import ctypes
import itertools
import types

import jax
import numpy as np
import pytest
import torch

from dla_tpu.kernels import collectives as JC
from dla_tpu_torch.kernels import collectives as C
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SMS = 132  # an H100's SMs
READY = C._DATA_WORDS  # the ready words' first index in a card's flag buffer

BCAST = [  # (ndev, m, n, dtype, root, chunks, group): the card tests' cases, then more
    (4, 1024, 1024, torch.float64, 1, None, None),  # the factor tile: C = 32
    (4, 1536, 256, torch.float64, 2, None, None),
    (8, 256, 8, torch.float32, 5, None, None),
    (8, 256, 8, torch.float32, 5, 16, 4),
    (8, 64, 40, torch.bfloat16, 1, 4, 2),
    (4, 96, 3, torch.float32, 3, 3, None),
    (4, 48, 5, torch.bfloat16, 0, 16, None),
    (3, 32, 7, torch.float64, 2, 1, None),
    (1, 64, 16, torch.float32, 0, 4, None),
    (4, 1024, 1024, torch.float64, 0, 32, 2),  # group 2, root at dist 0 of each sub-ring
    (4, 1024, 1024, torch.float64, 1, 32, 2),
    (4, 64, 8, torch.float64, 3, 4, 1),  # sub-rings of one member
    (3, 96, 40, torch.float64, 1, 1, None),  # chunks=1, D=3
    (4, 40, 7, torch.bfloat16, 2, 8, None),  # bf16, 14-byte rows
]

GATHER = [  # (ndev, m, n, dtype, group)
    (4, 1024, 1024, torch.float64, None),
    (4, 1024, 1024, torch.float64, 2),
    (8, 16, 6, torch.float32, 4),
    (8, 40, 8, torch.bfloat16, 2),
    (4, 7, 3, torch.float32, None),
    (2, 5, 5, torch.bfloat16, 1),
    (3, 33, 5, torch.bfloat16, None),  # D=3, bf16, ragged
]


@pytest.fixture(autouse=True)
def pretend_h100(monkeypatch):
    """``collectives._record`` asks the card for its SMs and ``_call`` for each
    card's current stream: here an H100's 132 and a stream per card."""
    monkeypatch.setattr(C, "_sms", lambda index: SMS)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda card: types.SimpleNamespace(cuda_stream=1000 + card.index))


class _Bytes:
    """A member block or output on pretended card ``card``: bytes on the CPU
    at an address of their own."""

    _next = [1 << 32]

    def __init__(self, data: torch.Tensor, card):
        self.bytes, self.device = data, card
        self.addr = _Bytes._next[0]
        _Bytes._next[0] += data.numel() + 4096

    def data_ptr(self):
        return self.addr

    def numel(self):
        return self.bytes.numel()

    def element_size(self):
        return 1


class _OnCard(_Bytes):
    """A contiguous member block or output on a pretended card."""

    def is_contiguous(self):
        return True


class _Flags:
    """A card's flag buffer: words at addresses base + 8·i, never cleared."""

    def __init__(self, index):
        self.base = (index + 1) << 48

    def data_ptr(self):
        return self.base


def _flag_card(addr):
    """(card index, word) of a flag address."""
    return (addr >> 48) - 1, (addr & ((1 << 48) - 1)) // 8


def _c_args(args) -> dict:
    """``dla_ring_launch``'s arguments by name, ctypes arrays as lists."""
    names = ("gather ndev group root xs outs cards flags block_bytes stripe segment base blocks "
             "nparts part_card part_size members streams sys").split()
    return dict(zip(names, [list(a) if isinstance(a, ctypes.Array) else a for a in args]))


def _block_program(a: dict, d: int, b: int) -> list:
    """The operations of block b of member d, as ``ring_kernel`` runs them:
    ("ready", word, value), ("wait", word, value, kind) with kind "data",
    "ready" or "final", ("copy", [(address, offset), ...], (address, offset),
    n), ("publish", word, value); a word is a flag address."""
    g, v, base = a["group"], a["block_bytes"], a["base"]
    r, c = divmod(d, g)
    right, left = r * g + (c + 1) % g, r * g + (c - 1) % g
    dist = c if a["gather"] else (c - a["root"]) % g
    sends, receives = C.member_roles(d, gather=a["gather"], group=g, root=a["root"])
    card, flags = a["cards"], a["flags"]
    me = card[d]
    remote_out = bool(a["sys"]) and sends and g > 1 and card[right] != me
    remote_in = bool(a["sys"]) and receives and card[left] != me
    s0 = b * a["stripe"]
    ln = min(a["stripe"], v - s0) if s0 < v else 0
    nseg = -(-ln // a["segment"])
    units = max(g - 1, 1) if a["gather"] else 1
    word = lambda dev, i: flags[dev] + 8 * i  # noqa: E731
    mine = word(me, d * a["blocks"] + b)
    ops = []
    if remote_in and b == 0:
        ops.append(("ready", word(card[left], READY + me * C.MAX_MEMBERS + d), base + 1))
    if sends:
        out, nxt = a["outs"][d], a["outs"][right] if g > 1 else None
        theirs = word(card[right], right * a["blocks"] + b) if g > 1 else None
        ready = not remote_out
        for u in range(units):
            off = (((dist - u) % g) * v if a["gather"] else 0) + s0
            own = u == 0 if a["gather"] else dist == 0
            raise_ = remote_out or (u + 1 < units if a["gather"] else dist + 1 < g - 1)
            for j in range(nseg):
                lo = j * a["segment"]
                n = min(a["segment"], ln - lo)
                if not own:
                    ops.append(("wait", mine, base + ((u - 1) * nseg if a["gather"] else 0)
                                + j + 1, "data"))
                if not ready:
                    ops.append(("wait", word(me, READY + card[right] * C.MAX_MEMBERS + right),
                                base + 1, "ready"))
                    ready = True
                if own:
                    dsts = [(out, off + lo)] + ([(nxt, off + lo)] if nxt else [])
                    ops.append(("copy", dsts, (a["xs"][d], s0 + lo), n))
                else:
                    ops.append(("copy", [(nxt, off + lo)], (out, off + lo), n))
                if raise_:
                    ops.append(("publish", theirs, base + u * nseg + j + 1))
    if remote_in:
        ops.append(("wait", mine, base + units * nseg, "final"))
    return ops


def _kernel_blocks(args) -> list:
    """Every part of one ``dla_ring_launch`` call: [(card, stream, [(member,
    block, ops), ...])], read off its C arguments as ``ring_kernel`` reads
    them (each part's member table, each member's card and flag row)."""
    a = _c_args(args)
    parts, k = [], 0
    for p in range(a["nparts"]):
        members = a["members"][k : k + a["part_size"][p]]
        k += a["part_size"][p]
        assert all(a["cards"][m] == a["part_card"][p] for m in members)
        parts.append((a["part_card"][p], a["streams"][p],
                      [(m, b, _block_program(a, m, b)) for m in members
                       for b in range(a["blocks"])]))
    return parts


class _Capture:
    """A stand-in for ``dla_ring_launch``: keeps each call's arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


def _host_call(xs, outs, *, gather, group, root, flags, blocks=0, cut=None, order=None,
               monkeypatch=None):
    """One collective through the wrapper's ``_record`` and ``_call`` with the
    stand-in launcher; ``order`` permutes the parts (card_launches' list).
    Returns (record, the launcher's arguments)."""
    if order is not None:
        real = C.card_launches
        monkeypatch.setattr(C, "card_launches",
                            lambda **kw: [real(**kw)[i] for i in order(len(real(**kw)))])
    rec = C._record(tuple(x.device for x in xs), xs[0].numel() * xs[0].element_size(),
                    gather=gather, group=group, root=root, blocks=blocks, cut=cut, flags=flags)
    if order is not None:
        monkeypatch.setattr(C, "card_launches", real)
    fn = _Capture()
    assert C._call(fn, rec, xs, outs) == 0
    return rec, fn.calls[0]


class Launch:
    """One launch on one card: its blocks' programs, run in a shuffled order;
    what it read and wrote."""

    def __init__(self, *, gather, ndev, group, root, block_bytes, base, blocks=0, cut=None,
                 data=None):
        card = torch.device("cuda", 0)
        self.ndev, self.group, self.gather, self.root = ndev, group, gather, root
        self.block_bytes, self.base = block_bytes, base
        out_bytes = (group if gather else 1) * block_bytes
        if data is None:
            data = [torch.empty(0, dtype=torch.uint8)] * ndev
        self.xs = [_Bytes(t, card) for t in data]
        for x in self.xs:  # the stand-in reads sizes only; metadata runs have no data
            x.numel = lambda block_bytes=block_bytes: block_bytes
        self.outs = [_Bytes(torch.full((out_bytes if data[0].numel() else 0,), 0xAB,
                                       dtype=torch.uint8), card) for _ in range(ndev)]
        self.owner = {o.addr: ("out", d) for d, o in enumerate(self.outs)}
        self.owner.update({x.addr: ("x", d) for d, x in enumerate(self.xs)})
        saved = C._epoch[0]
        C._epoch[0] = base
        try:
            rec, args = _host_call(self.xs, self.outs, gather=gather, group=group, root=root,
                                   flags={card: _Flags(0)}, blocks=blocks, cut=cut)
        finally:
            C._epoch[0] = saved
        self.plan = rec.plan
        (_, _, blocks_ops), = _kernel_blocks(args)
        self.members = [m for m, _, _ in blocks_ops]
        self.blocks = [b for _, b, _ in blocks_ops]
        self.programs = [ops for _, _, ops in blocks_ops]
        self.writes, self.reads = [], []  # (member, lo, hi, block, op index[, last wait])

    def left(self, d):
        return C.left_of(d, self.group)

    def run(self, flags, rng, with_data=True):
        """Every block to its end in a random order that respects the flags
        (``flags``: flag address -> value); the data too, if ``with_data``."""
        nblk = len(self.programs)
        pcs, last_wait = [0] * nblk, [None] * nblk
        ready, waiting = list(range(nblk)), {}
        done = 0
        while done < nblk:
            assert ready, "deadlock: every unfinished block waits on a flag"
            i = ready.pop(int(rng.integers(len(ready))))
            ops = self.programs[i]
            while pcs[i] < len(ops):
                op = ops[pcs[i]]
                if op[0] == "wait":
                    if flags.get(op[1], 0) < op[2]:
                        waiting.setdefault(op[1], []).append(i)
                        break
                    last_wait[i] = (op[1], op[2])
                elif op[0] == "publish":
                    assert flags.get(op[1], 0) < op[2], "a flag raised twice to one value"
                    flags[op[1]] = op[2]
                    ready.extend(waiting.pop(op[1], []))
                else:
                    _, dsts, (src, soff), n = op
                    if n:
                        kind, sm = self.owner[src]
                        if kind == "out":
                            self.reads.append((sm, soff, soff + n, i, pcs[i], last_wait[i]))
                        else:
                            self.reads.append(("x", sm, soff, soff + n))
                        for dst, doff in dsts:
                            self.writes.append((self.owner[dst][1], doff, doff + n, i, pcs[i]))
                            if with_data:
                                srcb = (self.xs if kind == "x" else self.outs)[sm].bytes
                                self.outs[self.owner[dst][1]].bytes[doff : doff + n] = \
                                    srcb[soff : soff + n]
                pcs[i] += 1
                if rng.integers(4) == 0 and pcs[i] < len(ops):  # let others run mid-program
                    ready.append(i)
                    break
            else:
                done += 1

    def check(self, out_bytes):
        """The properties that need no data (the module's docstring)."""
        g, blocks = self.group, self.plan.blocks
        by_member = {}
        for dm, lo, hi, i, j in self.writes:
            writer = self.members[i]
            assert writer in (dm, self.left(dm)), f"member {writer} wrote member {dm}'s output"
            by_member.setdefault(dm, []).append((lo, hi, i, j))
        for d in range(self.ndev):
            spans = sorted(by_member.get(d, []))
            assert spans and spans[0][0] == 0 and spans[-1][1] == out_bytes, \
                f"member {d}'s output is not covered"
            for (_, h0, *_), (l1, *_) in zip(spans, spans[1:]):
                assert h0 == l1, f"member {d}: a gap or an overlap at byte {h0}"
            by_member[d] = spans
        publishes = {}
        for i, ops in enumerate(self.programs):
            d = self.members[i]
            for j, op in enumerate(ops):
                assert op[0] not in ("ready",) and (op[0] != "wait" or op[3] == "data"), \
                    "a ready word or final wait on one card"
                if op[0] == "wait":
                    assert _flag_card(op[1])[1] // blocks == d and op[2] > self.base
                elif op[0] == "publish":
                    target = _flag_card(op[1])[1] // blocks
                    assert self.left(target) == d != target, "a flag raised by another than " \
                        "the left neighbour"
                    assert _flag_card(op[1])[1] % blocks == self.blocks[i]
                    publishes[(op[1], op[2])] = (i, j)
        for rd in self.reads:
            if rd[0] == "x":
                _, sm, lo, hi = rd
                assert self.gather or sm % g == self.root, f"member {sm}'s block was read"
                continue
            sm, lo, hi, i, j, seen = rd
            assert seen is not None, "a block read its output before any wait"
            writer, pj = publishes[seen]
            spans = by_member[sm]
            k = bisect.bisect_right(spans, (lo, float("inf"))) - 1
            while k < len(spans) and spans[k][0] < hi:
                wlo, whi, wi, wj = spans[k]
                if whi > lo:
                    assert wi == writer and wj < pj, "bytes forwarded before the flag " \
                        "that orders their write"
                k += 1
        read = sum(r[3] - r[2] if r[0] == "x" else r[2] - r[1] for r in self.reads)
        written = sum(hi - lo for _, lo, hi, _, _ in self.writes)
        rings, v = self.ndev // g, self.block_bytes
        if self.gather:
            want = (self.ndev * max(g - 1, 1) * v, self.ndev * g * v)
        else:
            want = (rings * max(g - 1, 1) * v, self.ndev * v)
        assert (read, written) == want


def _bytes(t):
    return t.contiguous().view(-1).view(torch.uint8).clone()


def _inputs(ndev, m, n, dtype, seed, nan_members=()):
    g = np.random.default_rng(seed)
    xs = [torch.from_numpy(g.standard_normal((m, n))).to(dtype) for _ in range(ndev)]
    for d in nan_members:
        xs[d].fill_(float("nan"))
    return xs


def _launch_bcast(xs, root, group, chunks, flags, base, seed, blocks=0, cut=None):
    ndev, _, group, root, chunks = C._bcast_args(xs, root, group, chunks)
    block_bytes = xs[0].numel() * xs[0].element_size()
    launch = Launch(gather=False, ndev=ndev, group=group, root=root, block_bytes=block_bytes,
                    base=base, blocks=blocks, cut=cut, data=[_bytes(x) for x in xs])
    launch.run(flags, np.random.default_rng(seed))
    launch.check(block_bytes)
    ref = C.ring_broadcast_plain(xs, root, group=group, chunks=chunks)
    for o, r in zip(launch.outs, ref):
        assert torch.equal(o.bytes, _bytes(r))
    return launch


def _launch_gather(xs, group, flags, base, seed, blocks=0, cut=None):
    ndev, _, _ = C._members("ring_all_gather", xs)
    group = C._group(ndev, group)
    block_bytes = xs[0].numel() * xs[0].element_size()
    launch = Launch(gather=True, ndev=ndev, group=group, root=0, block_bytes=block_bytes,
                    base=base, blocks=blocks, cut=cut, data=[_bytes(x) for x in xs])
    launch.run(flags, np.random.default_rng(seed))
    launch.check(group * block_bytes)
    ref = C.ring_all_gather_plain(xs, group=group)
    for o, r in zip(launch.outs, ref):
        assert torch.equal(o.bytes, _bytes(r))
    return launch


@pytest.mark.parametrize("ndev,m,n,dtype,root,chunks,group", BCAST)
def test_broadcast_schedule_gives_plain_bits(ndev, m, n, dtype, root, chunks, group):
    g = group or ndev
    roots = {r * g + root % g for r in range(ndev // g)}
    xs = _inputs(ndev, m, n, dtype, seed=m + n + ndev,
                 nan_members=[d for d in range(ndev) if d not in roots])
    for seed in range(2):
        _launch_bcast(xs, root, group, chunks, {}, 0, seed)


@pytest.mark.parametrize("ndev,m,n,dtype,group", GATHER)
def test_all_gather_schedule_gives_plain_bits(ndev, m, n, dtype, group):
    xs = _inputs(ndev, m, n, dtype, seed=3 * m + n)
    for seed in range(2):
        _launch_gather(xs, group, {}, 0, seed)


@pytest.mark.parametrize("min_segment,blocks,steps", [(16, 1, 30), (16, 2, 15), (48, 3, 3),
                                                      (16, 40, 1)])
def test_schedule_with_many_small_units_and_ragged_stripes(min_segment, blocks, steps):
    """Segments of a few bytes, ragged stripes, blocks with no bytes at all
    (40 blocks of 16-byte stripes over 480 bytes): the byte path, and every
    flag of a long pipeline."""
    cut = dict(C.CUT, min_segment=min_segment)
    xs = _inputs(4, 48, 5, torch.bfloat16, seed=9, nan_members=[0, 1, 3])
    launch = _launch_bcast(xs, 2, None, 16, {}, 0, seed=1, blocks=blocks, cut=cut)
    assert launch.plan.steps == steps
    _launch_gather(_inputs(4, 7, 3, torch.float32, seed=10), None, {}, 0, seed=2,
                   blocks=blocks, cut=cut)


def test_launches_back_to_back_share_never_cleared_flags():
    """Launches of other kinds and cuts on one flag buffer, each with the
    epoch the wrapper gives it: no flag that a launch left satisfies a wait
    of a later one."""
    flags, base = {}, 0
    for i in range(12):
        ndev, m = (4, 64 * (1 + i % 3)) if i % 4 else (8, 32)
        xs = _inputs(ndev, m, 16, torch.float32, seed=100 + i)
        assert max(flags.values(), default=0) <= base
        cut = dict(C.CUT, min_segment=(16, 64, 1024)[i % 3])
        if i % 5 == 4:
            launch = _launch_gather(xs, 2, flags, base, seed=i, blocks=1 + i % 3, cut=cut)
        else:
            launch = _launch_bcast(xs, i % ndev, None, (None, 1, 2, 4)[i % 4], flags, base,
                                   seed=i, blocks=1 + i % 3, cut=cut)
        base += launch.plan.steps


@pytest.mark.parametrize("kw,plan", [
    (dict(gather=False, group=4, per_card=3, block_bytes=15360 * 1024 * 8),
     C.RingPlan(blocks=88, stripe=1429888, segment=33264, units=1, steps=43)),
    (dict(gather=False, group=4, per_card=3, block_bytes=1024 * 1024 * 8),
     C.RingPlan(blocks=88, stripe=95328, segment=47664, units=1, steps=2)),
    (dict(gather=True, group=4, per_card=4, block_bytes=1024 * 1024 * 8),
     C.RingPlan(blocks=66, stripe=127104, segment=42368, units=3, steps=9)),
])
def test_plan_at_the_planes_shapes(kw, plan):
    """The one-card cut of the planes' panel and tile broadcasts and of the
    1024² all-gather on an H100, and the panel's schedule in metadata only."""
    assert C.ring_plan(sms=SMS, **kw, **C.CUT) == plan
    if kw["block_bytes"] == 15360 * 1024 * 8:
        launch = Launch(gather=False, ndev=4, group=4, root=1, block_bytes=kw["block_bytes"],
                        base=7)
        launch.run({}, np.random.default_rng(0), with_data=False)
        launch.check(kw["block_bytes"])


@pytest.mark.parametrize("kw,plan", [
    (dict(gather=False, group=4, block_bytes=15360 * 1024 * 8),
     C.RingPlan(blocks=132, stripe=953264, segment=32880, units=1, steps=29)),
    (dict(gather=False, group=4, block_bytes=1024 * 1024 * 8),
     C.RingPlan(blocks=132, stripe=63552, segment=63552, units=1, steps=1)),
    (dict(gather=True, group=4, block_bytes=1024 * 1024 * 8),
     C.RingPlan(blocks=132, stripe=63552, segment=63552, units=3, steps=3)),
])
def test_plan_across_cards_at_the_planes_shapes(kw, plan):
    """The cut across four cards, one member a card (per_card 1), of the
    same three collectives."""
    assert C.ring_plan(sms=SMS, per_card=1, **kw, **C.NVLINK_CUT) == plan


# ---- the ring across cards: the wrapper's record, the parts and their streams, modelled -------
#
# ``C._record`` and ``C._call`` are driven as on the card, with pretended cards: member blocks
# and outputs are byte arrays with addresses of their own, each card's flag buffer has its own
# address range, and each card's current stream is a queue. ``_simulate`` puts each part of the
# stand-in launcher's call on its card's queue, behind any earlier work queued there, and runs
# the queues in order (a part ends when all its blocks have) and every started block in a seeded
# shuffled order that respects only the flags and ready words, and a read of each card's outputs
# queued after the collective, as a caller's next kernel.


def _simulate(queues: dict, mem: dict, rng) -> list:
    """Run every card's queue to its end: ("earlier", address, n) writes n
    bytes of junk at address (work the caller queued before, on memory the
    allocator has since handed to an output), ("part", launch id, blocks)
    runs a collective's part, ("read", addresses) checks that those outputs
    have all their bytes. ``mem``: address -> byte array (blocks and
    outputs). Returns every wait (waiter member, kind, flag card, writer
    member)."""
    flags, written, writer_of, waits = {}, {a: torch.zeros(t.numel(), dtype=torch.bool)
                                            for a, t in mem.items()}, {}, []
    pending_early = {}  # address -> earlier work still queued on it
    for q in queues.values():
        for item in q:
            if item[0] == "earlier":
                pending_early[item[1]] = pending_early.get(item[1], 0) + 1
    left_ops = {}  # flag word -> {launch: its operations on the word still to run}
    for q in queues.values():
        for item in q:
            if item[0] == "part":
                for _, _, ops in item[2]:
                    for op in ops:
                        if op[0] in ("ready", "wait", "publish"):
                            per = left_ops.setdefault(op[1], {})
                            per[item[1]] = per.get(item[1], 0) + 1

    def touch(launch, word):
        per = left_ops[word]
        assert not any(count for other, count in per.items() if other < launch), \
            f"launch {launch} touched a flag word that an earlier launch still has ops on"
        per[launch] -= 1

    started, blocks = {}, []
    while True:
        moved = False
        for c in [list(queues)[i] for i in rng.permutation(len(queues))]:
            while queues[c]:
                item = queues[c][0]
                if item[0] == "earlier":
                    if rng.integers(4):  # earlier work takes a while
                        moved = True
                        break
                    _, addr, n = item
                    mem[addr][:n] = 0xEE
                    pending_early[addr] -= 1
                elif item[0] == "part":
                    key = id(item)
                    if key not in started:
                        started[key] = [[item[1], m, ops, 0] for m, _, ops in item[2]]
                        blocks.extend(started[key])
                    if any(bl[3] < len(bl[2]) for bl in started[key]):
                        break
                else:
                    for addr in item[1]:
                        assert bool(written[addr].all()), \
                            f"card {c} read an output before all its bytes landed"
                queues[c].pop(0)
                moved = True
        live = [bl for bl in blocks if bl[3] < len(bl[2])]
        ready = [bl for bl in live if bl[2][bl[3]][0] != "wait"
                 or flags.get(bl[2][bl[3]][1], 0) >= bl[2][bl[3]][2]]
        if ready:
            bl = ready[int(rng.integers(len(ready)))]
            for _ in range(1 + int(rng.integers(3))):  # a few ops, then let others run
                if bl[3] >= len(bl[2]):
                    break
                launch, member, ops, pc = bl
                kind, *rest = ops[pc]
                if kind == "wait":
                    if flags.get(rest[0], 0) < rest[1]:
                        break
                    touch(launch, rest[0])
                    waits.append((member, rest[2], _flag_card(rest[0])[0], writer_of[rest[0]]))
                elif kind in ("publish", "ready"):
                    touch(launch, rest[0])
                    assert flags.get(rest[0], 0) < rest[1], "a flag raised twice to one value"
                    flags[rest[0]] = rest[1]
                    writer_of[rest[0]] = member
                else:
                    dsts, (src, soff), n = rest
                    for dst, doff in dsts:
                        if n:
                            assert not pending_early.get(dst), \
                                "a write into an output whose card still runs earlier work on it"
                            assert not bool(written[dst][doff : doff + n].any()), \
                                "an output byte written twice"
                            mem[dst][doff : doff + n] = mem[src][soff : soff + n]
                            written[dst][doff : doff + n] = True
                bl[3] += 1
            moved = True
        if not moved:
            assert not live and not any(queues.values()), \
                "deadlock: no stream and no block can move"
            return waits


class _Cards:
    """Pretended cards: their flag buffers, and per card the queue of its
    current stream."""

    def __init__(self, ncards):
        self.cards = [torch.device("cuda", i) for i in range(ncards)]
        self.flags = {c: _Flags(c.index) for c in self.cards}
        self.queues = {c.index: [] for c in self.cards}
        self.launches = 0

    def enqueue(self, args):
        """The parts of one launcher call onto their cards' queues."""
        for card, stream, blocks in _kernel_blocks(args):
            assert stream == 1000 + card, "a part off its card's current stream"
            self.queues[card].append(("part", self.launches, blocks))
        self.launches += 1


def _collective(model, monkeypatch, *, gather, xs_bytes, group, root, member_card, order,
                cut=None, blocks=2):
    """One collective through the wrapper's host path on the pretended
    cards, its parts in ``order`` (a permutation of card_launches' list),
    queued; returns (outputs, mem entries, the record)."""
    ndev = len(xs_bytes)
    block_bytes = xs_bytes[0].numel()
    xs = [_Bytes(x, member_card[d]) for d, x in enumerate(xs_bytes)]
    outs = [_Bytes(torch.full(((group if gather else 1) * block_bytes,), 0xAB, dtype=torch.uint8),
                   member_card[d]) for d in range(ndev)]
    rec, args = _host_call(xs, outs, gather=gather, group=group, root=root, flags=model.flags,
                           blocks=blocks, cut=cut, order=order, monkeypatch=monkeypatch)
    model.enqueue(args)
    _check_peers(args, rec, {o.addr: o.device.index for o in outs})
    return outs, {b.addr: b.bytes for b in xs + outs}, rec


def _check_peers(args, rec, out_card: dict) -> None:
    """Every write a part makes into another card's memory (an output, a
    flag, a ready word) goes to a pair of cards whose peer access the record
    turns on."""
    for card, _, blocks in _kernel_blocks(args):
        for _, _, ops in blocks:
            for op in ops:
                if op[0] in ("publish", "ready"):
                    dst = {_flag_card(op[1])[0]}
                elif op[0] == "copy":
                    dst = {out_card[addr] for addr, _ in op[1]}
                else:
                    continue
                for other in dst - {card}:
                    assert (card, other) in rec.pairs, f"card {card} writes card {other}"



def _jax_ring(fn, x, ndev, out_rows):
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:ndev]), ("d",))
    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=jax.sharding.PartitionSpec("d", None),
                              out_specs=jax.sharding.PartitionSpec("d", None), check_vma=False))
    return np.asarray(f(x)).reshape(ndev, out_rows, x.shape[1])


ACROSS = [(ndev, group, per_card, gather) for ndev in (4, 8) for group in (1, 2, 4, 8)
          if group <= ndev for per_card in (1, 2) for gather in (False, True)]
SMALL_CUT = dict(blocks_per_sm=1, min_segment=64)  # 4 segments a block of 256 bytes


def _orders(ncards):
    """Every launch order of up to 4 cards; for more, 12 seeded orders."""
    if ncards <= 4:
        return [list(p) for p in itertools.permutations(range(ncards))]
    rng = np.random.default_rng(ncards)
    return [list(range(ncards)), list(reversed(range(ncards)))] + [
        list(rng.permutation(ncards)) for _ in range(10)]


def _check_waits(waits, member_card, group):
    """Every data and final wait on the waiter's own flag, on its card,
    raised by its left neighbour; every ready wait on a word on the waiter's
    card raised by its right neighbour."""
    for waiter, kind, flag_card, writer in waits:
        assert flag_card == member_card[waiter].index, "a flag off its waiter's card"
        want = C.right_of(waiter, group) if kind == "ready" else C.left_of(waiter, group)
        assert writer == want, f"a {kind} wait on a word that the wrong member raised"


def _across(monkeypatch, ndev, group, per_card, gather, *, earlier=False):
    """#11/#12 with the members spread over ndev/per_card cards, in every
    launch order of the parts; with ``earlier``, every card's stream first
    runs earlier work on the memory its outputs now hold."""
    m, n, root = 32, 4, 1
    g = torch.Generator().manual_seed(ndev * 10 + group)
    x = torch.randn(ndev * m, n, generator=g, dtype=torch.float64)
    xs = list(x.split(m))
    chunks = 4
    if gather:
        want = _jax_ring(lambda xl: JC.ring_all_gather(xl, "d", group=group), x.numpy(), ndev,
                         group * m)
        plain = C.ring_all_gather_plain(xs, group=group)
    else:
        want = _jax_ring(lambda xl: JC.ring_broadcast(xl, "d", root, group=group, chunks=chunks),
                         x.numpy(), ndev, m)
        plain = C.ring_broadcast_plain(xs, root, group=group, chunks=chunks)
    for d in range(ndev):
        np.testing.assert_array_equal(plain[d].numpy(), want[d])
    ncards = ndev // per_card
    for i, order in enumerate(_orders(ncards)):
        model = _Cards(ncards)
        member_card = [model.cards[d // per_card] for d in range(ndev)]
        monkeypatch.setattr(C, "_epoch", [0])
        xs_bytes = [_bytes(t) for t in xs]
        outs, mem, rec = _collective(model, monkeypatch, gather=gather, xs_bytes=xs_bytes,
                                     group=group, root=root % group, member_card=member_card,
                                     order=lambda k, order=order: [j for j in order if j < k],
                                     cut=SMALL_CUT)
        if earlier:
            for d, o in enumerate(outs):
                model.queues[member_card[d].index].insert(0, ("earlier", o.addr, o.numel()))
        for c in model.cards:
            model.queues[c.index].append(
                ("read", [o.addr for o, mc in zip(outs, member_card) if mc == c]))
        waits = _simulate(model.queues, mem, np.random.default_rng(i))
        _check_waits(waits, member_card, group)
        for d in range(ndev):
            assert torch.equal(mem[outs[d].addr], _bytes(plain[d])), f"member {d}"
        assert C._epoch[0] == rec.plan.steps


@pytest.mark.parametrize("ndev,group,per_card,gather", ACROSS)
def test_ring_across_cards_gives_jax_bits_in_every_launch_order(monkeypatch, ndev, group,
                                                                per_card, gather):
    """#11/#12 with the members spread over ndev/per_card cards: in every
    launch order of the cards' parts the outputs hold the bits of JAX's
    interpret-mode ring (and of the plain versions); every data wait is on
    the waiter's own flag, on its own card, raised by its left neighbour, and
    every ready wait on its own card's word raised by its right neighbour;
    every card's read after the collective (the last member's card of a
    broadcast, whose part only waits, included) sees all its bytes landed;
    no deadlock."""
    _across(monkeypatch, ndev, group, per_card, gather)


@pytest.mark.parametrize("group,per_card,gather", [(g, p, gather) for g in (2, 4)
                                                   for p in (1, 2) for gather in (False, True)])
def test_ring_across_cards_waits_for_receivers_with_earlier_work(monkeypatch, group, per_card,
                                                                 gather):
    """Every card's stream still holds earlier work on the memory that its
    members' outputs now hold (the caching allocator handed it out on the
    host before that work ran): in every launch order no hop writes into an
    output before its card's stream has passed that work, and the outputs
    hold the plain bits."""
    _across(monkeypatch, 4, group, per_card, gather, earlier=True)


@pytest.mark.parametrize("per_card", [1, 2])
def test_collectives_back_to_back_across_cards(monkeypatch, per_card):
    """A broadcast over the whole ring, then sub-rings of 2 whose left
    neighbours are other members (so one flag word gets another writer),
    then an all-gather, then a broadcast of another cut, the members placed
    on the cards in turn in two ways (member d on card d // per_card, then
    on another card), on one set of never-cleared flags and one epoch for
    every card, in two launch orders, all queued before any runs; each
    collective's bits, every flag left below the next collective's waits,
    and no flag or ready word touched by a launch while an earlier one still
    has an operation on it."""
    ndev, m, n = 8, 16, 4
    ncards = ndev // per_card
    cuts = [SMALL_CUT, dict(SMALL_CUT, min_segment=16), dict(SMALL_CUT, min_segment=32), None]
    for order in (lambda k: list(range(k)), lambda k: list(reversed(range(k)))):
        model = _Cards(ncards)
        placements = [[model.cards[d // per_card] for d in range(ndev)],
                      [model.cards[(ncards - 1 - d) % ncards] for d in range(ndev)]]
        monkeypatch.setattr(C, "_epoch", [0])
        mem, reads, checks = {}, {c.index: [] for c in model.cards}, []
        for i, (gather, group, root) in enumerate([(False, 8, 3), (False, 2, 1), (True, 4, 0),
                                                   (False, 8, 6)]):
            xs = list(torch.randn(ndev * m, n, generator=torch.Generator().manual_seed(i),
                                  dtype=torch.float32).split(m))
            member_card = placements[i % 2]
            outs, got, _ = _collective(model, monkeypatch, gather=gather,
                                       xs_bytes=[_bytes(t) for t in xs], group=group, root=root,
                                       member_card=member_card, order=order, cut=cuts[i],
                                       blocks=(2, 3, 1, 2)[i])
            mem.update(got)
            plain = (C.ring_all_gather_plain(xs, group=group) if gather
                     else C.ring_broadcast_plain(xs, root, group=group, chunks=4))
            checks += [(o.addr, _bytes(p)) for o, p in zip(outs, plain)]
            for o, mc in zip(outs, member_card):
                reads[mc.index].append(o.addr)
        for c, addrs in reads.items():
            model.queues[c].append(("read", addrs))
        _simulate(model.queues, mem, np.random.default_rng(per_card))
        for addr, want in checks:
            assert torch.equal(mem[addr], want)


def test_repeat_call_reuses_its_launch_record(monkeypatch):
    """``_launch`` makes a collective's launch record once: a repeat call
    only fills in the pointers, the streams and the epoch (the same ctypes
    arrays reach the launcher), and it checks peer access again once the
    enabled pairs are forgotten; a failed launch leaves the epoch."""
    cards = [torch.device("cuda", i) for i in range(2)]
    flags = {c: _Flags(c.index) for c in cards}
    monkeypatch.setattr(C, "_flags", flags)
    monkeypatch.setattr(C, "_records", {})
    monkeypatch.setattr(C, "_epoch", [5])
    monkeypatch.setattr(C, "_peers", set())
    enabled = []
    monkeypatch.setattr(C, "_enable_peers", lambda pairs: (enabled.append(list(pairs)),
                                                           C._peers.update(pairs)))
    fn = _Capture()
    monkeypatch.setattr(C, "_entry", lambda: fn)
    xs = [_OnCard(torch.zeros(128, dtype=torch.uint8), c) for c in cards]
    outs = [_OnCard(torch.zeros(128, dtype=torch.uint8), c) for c in cards]
    for _ in range(3):
        C._launch("ring_broadcast", xs, outs, gather=False, group=2, root=0)
    assert len(C._records) == 1 and enabled == [[(0, 1), (1, 0)]]
    first, *rest = [_c_args(a) for a in fn.calls]
    assert [a["base"] for a in (first, *rest)] == [5, 6, 7]
    assert all(a is b for a, b in zip(fn.calls[0][4:8], fn.calls[2][4:8]))
    C._peers.clear()
    C._launch("ring_broadcast", xs, outs, gather=False, group=2, root=0)
    assert len(enabled) == 2 and len(C._records) == 1
    monkeypatch.setattr(C, "_entry", lambda: lambda *a: 1)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        C._launch("ring_broadcast", xs, outs, gather=False, group=2, root=0)
    assert C._epoch[0] == 9


def test_a_ready_word_is_raised_by_one_card_only(monkeypatch):
    """Member 1 receives from member 0 (card 0) on card 1 in one broadcast
    and on card 2 in the next, while card 1's stream still runs earlier work
    on its output. Card 2's ready for the second broadcast must not release
    card 0's sender of the first: the ready word is keyed by the card that
    raises it, so the first broadcast writes into card 1 only after card 1
    has reached it, for every order of the streams."""
    m, n = 16, 4
    for seed in range(8):
        model = _Cards(3)
        monkeypatch.setattr(C, "_epoch", [0])
        mem, checks = {}, []
        for i, where in enumerate(([0, 1], [0, 2])):
            member_card = [model.cards[c] for c in where]
            xs = list(torch.randn(2 * m, n, generator=torch.Generator().manual_seed(i),
                                  dtype=torch.float32).split(m))
            outs, got, _ = _collective(model, monkeypatch, gather=False,
                                       xs_bytes=[_bytes(t) for t in xs], group=2, root=0,
                                       member_card=member_card, order=None, cut=SMALL_CUT)
            mem.update(got)
            if i == 0:
                model.queues[1].insert(0, ("earlier", outs[1].addr, outs[1].numel()))
            checks += [(o.addr, _bytes(p)) for o, p in
                       zip(outs, C.ring_broadcast_plain(xs, 0, group=2))]
            for o, mc in zip(outs, member_card):
                model.queues[mc.index].append(("read", [o.addr]))
        _simulate(model.queues, mem, np.random.default_rng(seed))
        for addr, want in checks:
            assert torch.equal(mem[addr], want)
