"""The schedule of the ring kernel ``csrc/ring.cu`` (``ring_broadcast`` and
``ring_all_gather`` on one card), written as torch byte copies on the CPU and
held to the bits of the plain versions.

``_program`` lists what one thread block of ``ring_kernel`` does, line for
line: for each pipeline unit, the flag it waits on, the bytes it copies from
where to where, and the flag it raises, with the launch cut by the wrapper's
own ``ring_plan``. ``_run`` runs all blocks of a launch in a seeded shuffled
order that respects only the flags (a block that waits on a flag not yet
raised stays blocked), as the card may. The tests require

- the plain versions' bits in every member's output;
- every output byte written exactly once, and every write into member d's
  output made by d itself or by its left neighbour in its sub-ring;
- every wait on the waiting member's own flag, which only its left
  neighbour raises: no wait points rightward or at itself, so none deadlocks;
- every byte a block forwards written before the flag raise that its last
  wait saw (the release/acquire pair of the kernel), in the writer's
  program order: read off the programs, not off one lucky order;
- no read of a non-root member's block (NaN-filled here);
- the bytes read and written: V + (group − 2)·V read, group·V written per
  sub-ring for the broadcast; (group − 1)·V read, group·V written per member
  for the all-gather;
- flags never cleared: every wait of a launch above every flag that earlier
  launches left.

The planes' 15360 × 1024 fp64 panel at C=48 is checked in metadata only
(intervals, no data).
"""

import bisect
import ctypes
import itertools

import jax
import numpy as np
import pytest
import torch

from dla_tpu.kernels import collectives as JC
from dla_tpu_torch.kernels import collectives as C
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SMS = 132  # an H100's SMs

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


def _program(plan, *, gather, ndev, group, root, block_bytes, base, w, b):
    """(member, operations) of block b of sender w, as ``ring_kernel`` runs
    them: ("copy", [(member, offset), ...], (buffer, member, offset), n),
    ("wait", flag, value), ("publish", flag, value); flag = member·B + b."""
    g = group
    per_ring = plan.senders // (ndev // g)  # the launcher's check, the kernel's division
    r, k = divmod(w, per_ring)
    c = k if gather else (root + k) % g
    d, right = r * g + c, r * g + (c + 1) % g
    s0 = b * plan.stripe
    n = min(plan.stripe, plan.unit_bytes - s0) if s0 < plan.unit_bytes else 0
    ops = []
    for u in range(plan.units):
        off = (((c - u) % g) * block_bytes if gather else u * plan.unit_bytes) + s0
        if (u == 0) if gather else (k == 0):
            dsts = [(d, off)] + ([(right, off)] if g > 1 else [])
            ops.append(("copy", dsts, ("x", d, s0 if gather else off), n))
        else:
            ops.append(("wait", d * plan.blocks + b, base + u + (0 if gather else 1)))
            ops.append(("copy", [(right, off)], ("out", d, off), n))
        if (u + 1 < plan.units) if gather else (k + 1 < per_ring):
            ops.append(("publish", right * plan.blocks + b, base + u + 1))
    return d, ops


class Launch:
    """One launch's programs, run in a shuffled order; what it read and wrote."""

    def __init__(self, *, gather, ndev, group, root, chunks, block_bytes, base, blocks=0):
        self.plan = C.ring_plan(gather=gather, ndev=ndev, group=group, chunks=chunks,
                                block_bytes=block_bytes, sms=SMS, blocks=blocks)
        self.ndev, self.group, self.gather, self.root = ndev, group, gather, root
        self.block_bytes, self.base = block_bytes, base
        self.members, self.programs = [], []
        for w in range(self.plan.senders):
            for b in range(self.plan.blocks):
                d, ops = _program(self.plan, gather=gather, ndev=ndev, group=group, root=root,
                                  block_bytes=block_bytes, base=base, w=w, b=b)
                self.members.append(d)
                self.programs.append(ops)
        self.writes, self.reads = [], []  # (member, lo, hi, block, op index[, last wait])

    def left(self, d):
        g = self.group
        return d // g * g + (d % g - 1) % g

    def run(self, flags, rng, xs=None, outs=None):
        """Every block to its end in a random order that respects the flags;
        ``xs`` and ``outs`` (flat uint8 per member) get the data, if given."""
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
                    if flags[op[1]] < op[2]:
                        waiting.setdefault(op[1], []).append(i)
                        break
                    last_wait[i] = (op[1], op[2])
                elif op[0] == "publish":
                    assert flags[op[1]] < op[2], "a flag raised twice to one value"
                    flags[op[1]] = op[2]
                    woken = waiting.pop(op[1], [])
                    ready.extend(woken)
                else:
                    _, dsts, (buf, sm, soff), n = op
                    if n:
                        if buf == "out":
                            self.reads.append((sm, soff, soff + n, i, pcs[i], last_wait[i]))
                        else:
                            self.reads.append(("x", sm, soff, soff + n))
                        for dm, doff in dsts:
                            self.writes.append((dm, doff, doff + n, i, pcs[i]))
                            if outs is not None:
                                src = xs[sm] if buf == "x" else outs[sm]
                                outs[dm][doff : doff + n] = src[soff : soff + n]
                pcs[i] += 1
                if rng.integers(4) == 0 and pcs[i] < len(ops):  # let others run mid-program
                    ready.append(i)
                    break
            else:
                done += 1

    def check(self, out_bytes):
        """The properties that need no data (the module's docstring)."""
        g, plan = self.group, self.plan
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
                if op[0] == "wait":
                    assert op[1] // plan.blocks == d and op[2] > self.base
                elif op[0] == "publish":
                    target = op[1] // plan.blocks
                    assert self.left(target) == d != target, "a flag raised by another than " \
                        "the left neighbour"
                    assert op[1] % plan.blocks == i % plan.blocks
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


def _launch_bcast(xs, root, group, chunks, flags, base, seed, blocks=0):
    ndev, _, group, root, chunks = C._bcast_args(xs, root, group, chunks)
    block_bytes = xs[0].numel() * xs[0].element_size()
    launch = Launch(gather=False, ndev=ndev, group=group, root=root, chunks=chunks,
                    block_bytes=block_bytes, base=base, blocks=blocks)
    outs = [torch.full((block_bytes,), 0xAB, dtype=torch.uint8) for _ in range(ndev)]
    launch.run(flags, np.random.default_rng(seed), [_bytes(x) for x in xs], outs)
    launch.check(block_bytes)
    ref = C.ring_broadcast_plain(xs, root, group=group, chunks=chunks)
    for o, r in zip(outs, ref):
        assert torch.equal(o, _bytes(r))
    return launch


def _launch_gather(xs, group, flags, base, seed, blocks=0):
    ndev, _, _ = C._members("ring_all_gather", xs)
    group = C._group(ndev, group)
    block_bytes = xs[0].numel() * xs[0].element_size()
    launch = Launch(gather=True, ndev=ndev, group=group, root=0, chunks=1,
                    block_bytes=block_bytes, base=base, blocks=blocks)
    outs = [torch.full((group * block_bytes,), 0xAB, dtype=torch.uint8) for _ in range(ndev)]
    launch.run(flags, np.random.default_rng(seed), [_bytes(x) for x in xs], outs)
    launch.check(group * block_bytes)
    ref = C.ring_all_gather_plain(xs, group=group)
    for o, r in zip(outs, ref):
        assert torch.equal(o, _bytes(r))
    return launch


def _flags():
    return [0] * C._FLAG_WORDS


@pytest.mark.parametrize("ndev,m,n,dtype,root,chunks,group", BCAST)
def test_broadcast_schedule_gives_plain_bits(ndev, m, n, dtype, root, chunks, group):
    g = group or ndev
    roots = {r * g + root % g for r in range(ndev // g)}
    xs = _inputs(ndev, m, n, dtype, seed=m + n + ndev,
                 nan_members=[d for d in range(ndev) if d not in roots])
    for seed in range(2):
        _launch_bcast(xs, root, group, chunks, _flags(), 0, seed)


@pytest.mark.parametrize("ndev,m,n,dtype,group", GATHER)
def test_all_gather_schedule_gives_plain_bits(ndev, m, n, dtype, group):
    xs = _inputs(ndev, m, n, dtype, seed=3 * m + n)
    for seed in range(2):
        _launch_gather(xs, group, _flags(), 0, seed)


@pytest.mark.parametrize("min_segment,blocks,units", [(16, 1, 16), (16, 2, 8), (48, 3, 2),
                                                       (16, 40, 1)])
def test_schedule_with_many_small_units_and_ragged_stripes(monkeypatch, min_segment, blocks,
                                                           units):
    """Units of a few bytes, ragged stripes, blocks with no bytes at all
    (40 blocks of 16-byte stripes): the byte path, and every flag of a long
    pipeline."""
    monkeypatch.setattr(C, "MIN_SEGMENT", min_segment)
    xs = _inputs(4, 48, 5, torch.bfloat16, seed=9, nan_members=[0, 1, 3])
    launch = _launch_bcast(xs, 2, None, 16, _flags(), 0, seed=1, blocks=blocks)
    assert launch.plan.units == units
    _launch_gather(_inputs(4, 7, 3, torch.float32, seed=10), None, _flags(), 0, seed=2,
                   blocks=blocks)


def test_launches_back_to_back_share_never_cleared_flags():
    """Launches of other kinds and cuts on one flag buffer, each with the
    epoch the wrapper gives it: no flag that a launch left satisfies a wait
    of a later one."""
    flags, base = _flags(), 0
    for i in range(12):
        ndev, m = (4, 64 * (1 + i % 3)) if i % 4 else (8, 32)
        xs = _inputs(ndev, m, 16, torch.float32, seed=100 + i)
        assert max(flags) <= base
        if i % 5 == 4:
            launch = _launch_gather(xs, 2, flags, base, seed=i, blocks=1 + i % 3)
        else:
            launch = _launch_bcast(xs, i % ndev, None, (None, 1, 2, 4)[i % 4], flags, base,
                                   seed=i, blocks=1 + i % 3)
        base += launch.plan.units


@pytest.mark.parametrize("kw,plan", [
    (dict(gather=False, ndev=4, group=4, chunks=48, block_bytes=15360 * 1024 * 8),
     C.RingPlan(senders=3, blocks=88, units=24, unit_bytes=5242880, stripe=59584)),
    (dict(gather=False, ndev=4, group=4, chunks=32, block_bytes=1024 * 1024 * 8),
     C.RingPlan(senders=3, blocks=88, units=2, unit_bytes=4194304, stripe=47664)),
    (dict(gather=True, ndev=4, group=4, chunks=1, block_bytes=1024 * 1024 * 8),
     C.RingPlan(senders=4, blocks=66, units=3, unit_bytes=8388608, stripe=127104)),
])
def test_plan_at_the_planes_shapes(kw, plan):
    """The cut of the planes' panel and tile broadcasts and of the 1024²
    all-gather on an H100, and the panel's schedule in metadata only."""
    assert C.ring_plan(sms=SMS, **kw) == plan
    if kw["block_bytes"] == 15360 * 1024 * 8:
        launch = Launch(root=1, base=7, **kw)
        launch.run(_flags(), np.random.default_rng(0))
        launch.check(kw["block_bytes"])


# ---- the ring across cards: the wrapper's launches, streams and events, modelled ---------------
#
# ``C._call`` is driven as it is on the card, with pretended cards: member blocks and outputs
# are byte arrays with addresses of their own, each card's flag buffer has its own address
# range, and torch.cuda's streams, events and device guard are replaced by a log of what the
# host enqueues on each card. The fake ``dla_ring_launch`` turns each card's launch into its
# thread blocks, read off the C arguments as ``ring_kernel`` reads them (its sender table,
# each member's flag row). ``_simulate`` then runs every card's stream in order (an event
# wait holds its stream until the event's record has run; a launch ends when all its blocks
# have) and every started block in a seeded shuffled order that respects only the flags, and
# a read of each card's outputs queued after the collective, as a caller's next kernel.


class _Bytes:
    """A member block or output on pretended card ``card``: bytes on the CPU."""

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


class _Flags:
    """A card's flag buffer: words at addresses base + 8·i, never cleared."""

    def __init__(self, index):
        self.base, self.words = (index + 1) << 48, {}

    def data_ptr(self):
        return self.base


class _Event:
    def record(self, stream):
        stream.host.append((stream.card, ("record", self)))


class _Stream:
    def __init__(self, card, host):
        self.card, self.host, self.cuda_stream = card, host, 1000 + card.index

    def wait_event(self, event):
        self.host.append((self.card, ("wait", event)))


class _Cards:
    """The host's view of pretended cards: its enqueue log, per card the
    stream, and the launches the fake ``dla_ring_launch`` was given."""

    def __init__(self, monkeypatch, ncards):
        self.cards = [torch.device("cuda", i) for i in range(ncards)]
        self.host, self.flags, self.current = [], {c: _Flags(c.index) for c in self.cards}, [None]
        self.streams = {c: _Stream(c, self.host) for c in self.cards}
        guard = self

        class Device:
            def __init__(self, card):
                self.card = card

            def __enter__(self):
                guard.current[0] = self.card

            def __exit__(self, *exc):
                guard.current[0] = None

        monkeypatch.setattr(torch.cuda, "Event", _Event)
        monkeypatch.setattr(torch.cuda, "current_stream", lambda card: self.streams[card])
        monkeypatch.setattr(torch.cuda, "device", Device)

    def launch(self, *args):
        """The fake ``dla_ring_launch``: logs the launch on its stream."""
        args = [list(a) if isinstance(a, ctypes.Array) else a for a in args]
        card = next(c for c, s in self.streams.items() if s.cuda_stream == args[-1])
        assert self.current[0] == card, "a launch enqueued while another card is current"
        self.host.append((card, ("launch", args)))
        return 0

    def where(self, addr):
        """(card, word) of a flag address."""
        card = next(c for c, f in self.flags.items() if f.base <= addr < f.base + (1 << 40))
        return card, (addr - self.flags[card].base) // 8


def _kernel_blocks(args, members, outs_of):
    """The thread blocks of one card's launch, read off ``dla_ring_launch``'s
    arguments as ``ring_kernel`` reads them: (member, ops) per block, ops as
    ``_program``'s but with flag addresses."""
    (gather, ndev, group, root, per_ring, units, xp, op, fp, block_bytes, unit_bytes, stripe,
     base, blocks, nsend, senders, sys, _) = args
    g, out = group, []
    for w in senders[:nsend]:
        for b in range(blocks):
            r, k = divmod(w, per_ring)
            c = k if gather else (root + k) % g
            d, right = r * g + c, r * g + (c + 1) % g
            s0 = b * stripe
            n = min(stripe, unit_bytes - s0) if s0 < unit_bytes else 0
            ops = []
            for u in range(units):
                off = (((c - u) % g) * block_bytes if gather else u * unit_bytes) + s0
                if (u == 0) if gather else (k == 0):
                    dsts = [(op[d], off)] + ([(op[right], off)] if g > 1 else [])
                    ops.append(("copy", dsts, (xp[d], s0 if gather else off), n))
                else:
                    ops.append(("wait", fp[d] + 8 * b, base + u + (0 if gather else 1)))
                    ops.append(("copy", [(op[right], off)], (op[d], off), n))
                if (u + 1 < units) if gather else (k + 1 < per_ring):
                    ops.append(("publish", fp[right] + 8 * b, base + u + 1))
            out.append((d, ops))
    return out


def _simulate(model: _Cards, mem: dict, member_card: dict, rng, reads: dict):
    """Run the logged streams and the blocks of every started launch to the
    end in a seeded order; ``mem``: address -> byte array (blocks and
    outputs), ``member_card``: output address -> card, ``reads``: card ->
    the output addresses that a read queued after the collectives checks.
    Returns every flag wait (waiter member, flag card, writer member)."""
    queues = {c: [op for cc, op in model.host if cc == c] for c in model.cards}
    for c, outs in reads.items():
        queues[c].append(("read", outs))
    recorded, started, blocks, waits = set(), {}, [], []
    written = {addr: torch.zeros(t.numel(), dtype=torch.bool) for addr, t in mem.items()}
    flag_writer = {}

    def flag(addr):
        card, word = model.where(addr)
        return model.flags[card].words.get(word, 0)

    while True:
        moved = False
        for c in [model.cards[i] for i in rng.permutation(len(model.cards))]:
            while queues[c]:
                kind, what = queues[c][0]
                if kind == "record":
                    recorded.add(id(what))
                elif kind == "wait" and id(what) not in recorded:
                    break
                elif kind == "launch":
                    key = id(what)
                    if key not in started:
                        started[key] = [[d, ops, 0] for d, ops in
                                        _kernel_blocks(what, None, None)]
                        blocks.extend(started[key])
                    if any(bl[2] < len(bl[1]) for bl in started[key]):
                        break
                elif kind == "read":
                    for addr in what:
                        assert bool(written[addr].all()), \
                            f"{c} read an output before all its bytes landed"
                queues[c].pop(0)
                moved = True
        live = [bl for bl in blocks if bl[2] < len(bl[1])]
        ready = [bl for bl in live if bl[1][bl[2]][0] != "wait"
                 or flag(bl[1][bl[2]][1]) >= bl[1][bl[2]][2]]
        if ready:
            bl = ready[int(rng.integers(len(ready)))]
            for _ in range(1 + int(rng.integers(3))):  # a few ops, then let others run
                if bl[2] >= len(bl[1]):
                    break
                kind, *rest = bl[1][bl[2]]
                if kind == "wait":
                    if flag(rest[0]) < rest[1]:
                        break
                    waits.append((bl[0], model.where(rest[0])[0], flag_writer[rest[0]]))
                elif kind == "publish":
                    card, word = model.where(rest[0])
                    assert model.flags[card].words.get(word, 0) < rest[1]
                    model.flags[card].words[word] = rest[1]
                    flag_writer[rest[0]] = bl[0]
                else:
                    dsts, (src, soff), n = rest
                    for dst, doff in dsts:
                        if n:
                            assert not bool(written[dst][doff : doff + n].any()), \
                                "an output byte written twice"
                            mem[dst][doff : doff + n] = mem[src][soff : soff + n]
                            written[dst][doff : doff + n] = True
                bl[2] += 1
            moved = True
        if not moved:
            assert not live and not any(queues.values()), \
                "deadlock: no stream and no block can move"
            return waits


def _collective(model, monkeypatch, *, gather, xs_bytes, group, root, chunks, member_card, order):
    """One collective through ``C._call`` on the pretended cards, its cards'
    launches enqueued in ``order`` (a permutation of card_launches' list);
    returns (outputs, mem entries, output addresses per card)."""
    ndev = len(xs_bytes)
    block_bytes = xs_bytes[0].numel()
    xs = [_Bytes(x, member_card[d]) for d, x in enumerate(xs_bytes)]
    outs = [_Bytes(torch.full(((group if gather else 1) * block_bytes,), 0xAB, dtype=torch.uint8),
                   member_card[d]) for d in range(ndev)]
    real = C.card_launches
    monkeypatch.setattr(C, "card_launches",
                        lambda **kw: [real(**kw)[i] for i in order(len(real(**kw)))])
    launches = real(gather=gather, ndev=ndev, group=group, root=root, cards=member_card)
    plan = C.ring_plan(gather=gather, ndev=ndev, group=group, chunks=chunks,
                       block_bytes=block_bytes, sms=SMS, blocks=2,
                       per_card=max(len(ws) for _, ws in launches))
    err = C._call(model.launch, model.flags, xs, outs, gather=gather, group=group, root=root,
                  plan=plan)
    assert err == 0
    monkeypatch.setattr(C, "card_launches", real)
    return outs, {b.addr: b.bytes for b in xs + outs}


def _check_host_order(model):
    """Every event that a card's stream waits on before its launch was
    recorded before any launch of the collective was enqueued, on a stream
    whose own launch comes after it: no card's launch waits on a launch
    enqueued after it (or on any launch)."""
    first_launch = next(i for i, (_, (kind, _)) in enumerate(model.host) if kind == "launch")
    recorded_at = {id(ev): i for i, (_, (kind, ev)) in enumerate(model.host) if kind == "record"}
    for i, (card, (kind, what)) in enumerate(model.host):
        if kind == "wait":
            later_launch = any(c == card and k == "launch"
                               for c, (k, _) in model.host[i + 1 :])
            if later_launch:
                assert recorded_at[id(what)] < first_launch


def _jax_ring(fn, x, ndev, out_rows):
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:ndev]), ("d",))
    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=jax.sharding.PartitionSpec("d", None),
                              out_specs=jax.sharding.PartitionSpec("d", None), check_vma=False))
    return np.asarray(f(x)).reshape(ndev, out_rows, x.shape[1])


ACROSS = [(ndev, group, per_card, gather) for ndev in (4, 8) for group in (1, 2, 4, 8)
          if group <= ndev for per_card in (1, 2) for gather in (False, True)]


def _orders(ncards):
    """Every launch order of up to 4 cards; for more, 12 seeded orders."""
    if ncards <= 4:
        return [list(p) for p in itertools.permutations(range(ncards))]
    rng = np.random.default_rng(ncards)
    return [list(range(ncards)), list(reversed(range(ncards)))] + [
        list(rng.permutation(ncards)) for _ in range(10)]


@pytest.mark.parametrize("ndev,group,per_card,gather", ACROSS)
def test_ring_across_cards_gives_jax_bits_in_every_launch_order(monkeypatch, ndev, group,
                                                                per_card, gather):
    """#11/#12 with the members spread over ndev/per_card cards: in every
    launch order of the cards the outputs hold the bits of JAX's
    interpret-mode ring (and of the plain versions); every wait is on the
    waiter's own flag, on its own card, raised by its left neighbour; no
    launch waits on a launch enqueued after it; every card's read after the
    collective (the last member's card of a broadcast, which launches
    nothing, included) sees all its bytes landed; no deadlock."""
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
        model = _Cards(monkeypatch, ncards)
        member_card = [model.cards[d // per_card] for d in range(ndev)]
        monkeypatch.setattr(C, "_epoch", [0])
        outs, mem = _collective(model, monkeypatch, gather=gather, xs_bytes=[_bytes(t) for t in xs],
                                group=group, root=root % group, chunks=chunks,
                                member_card=member_card,
                                order=lambda k: [j for j in order if j < k])
        _check_host_order(model)
        reads = {c: [o.addr for o, mc in zip(outs, member_card) if mc == c]
                 for c in model.cards}
        waits = _simulate(model, mem, member_card, np.random.default_rng(i), reads)
        for waiter, flag_card, writer in waits:
            assert flag_card == member_card[waiter], "a flag off its waiter's card"
            assert writer == waiter // group * group + (waiter % group - 1) % group, \
                "a wait on a flag that its left neighbour did not raise"
        for d in range(ndev):
            assert torch.equal(mem[outs[d].addr], _bytes(plain[d]))
        assert C._epoch[0] == C.ring_plan(
            gather=gather, ndev=ndev, group=group, chunks=chunks, block_bytes=m * n * 8,
            sms=SMS, blocks=2).units


@pytest.mark.parametrize("per_card", [1, 2])
def test_collectives_back_to_back_across_cards(monkeypatch, per_card):
    """A broadcast over the whole ring, then sub-rings of 2 whose left
    neighbours are other members (so one flag word gets another writer),
    then an all-gather, on one set of never-cleared flags and one epoch for
    every card: simulated as one queue, in two launch orders; each
    collective's bits, every flag left below the next collective's waits."""
    ndev, m, n = 8, 16, 4
    ncards = ndev // per_card
    for order in (lambda k: list(range(k)), lambda k: list(reversed(range(k)))):
        model = _Cards(monkeypatch, ncards)
        member_card = [model.cards[d // per_card] for d in range(ndev)]
        monkeypatch.setattr(C, "_epoch", [0])
        mem, reads, checks = {}, {c: [] for c in model.cards}, []
        for i, (gather, group, root) in enumerate([(False, 8, 3), (False, 2, 1), (True, 4, 0),
                                                   (False, 8, 6)]):
            xs = list(torch.randn(ndev * m, n, generator=torch.Generator().manual_seed(i),
                                  dtype=torch.float32).split(m))
            base = C._epoch[0]
            assert all(v <= base for f in model.flags.values() for v in f.words.values())
            outs, got = _collective(model, monkeypatch, gather=gather,
                                    xs_bytes=[_bytes(t) for t in xs], group=group, root=root,
                                    chunks=4, member_card=member_card, order=order)
            mem.update(got)
            plain = (C.ring_all_gather_plain(xs, group=group) if gather
                     else C.ring_broadcast_plain(xs, root, group=group, chunks=4))
            checks += [(o.addr, _bytes(p)) for o, p in zip(outs, plain)]
            for o, mc in zip(outs, member_card):
                reads[mc].append(o.addr)
        _simulate(model, mem, member_card, np.random.default_rng(per_card), reads)
        for addr, want in checks:
            assert torch.equal(mem[addr], want)
