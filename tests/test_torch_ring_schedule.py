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

import numpy as np
import pytest
import torch

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
