"""Where a ring collective's time goes across the cards: ``%globaltimer`` stamps
per stage of a patched copy of ``csrc/ring.cu``.

    python -m dla_tpu_torch.bench.ring_stages_probe [--m 1024] [--gather] [--calls 10]

The copy is patched by text anchors (the script fails loudly if the kernel's
code moved) so that block 0 of every member stamps (thread 0, and thread 32
for the waits of the across-card loop), into a buffer on its own card: its
entry, its ready word raised (a receiver from another
card), the ready word seen (a sender into another card), each data flag seen
and each flag raised, the final wait passed, and its exit. It runs #11 (or
#12 with ``--gather``) with one fp64 member of m × 1024 on each visible card
through the wrapper's own host path (``collectives._record`` and ``_call``,
the wrapper's cut): once after every card is idle, then ``--calls`` calls
queued behind a sleeping kernel on every card (the steady state of the
cards' time). It prints, per member, each stage's time from that member's
entry, and for the queued calls the period between entries on each card and
its split: entry to the ready word seen, to the first data, to the exit.
Each card reads its own ``%globaltimer``; times on two cards are compared
only as differences on one card. The build's outputs are checked against the
plain version's bits. With the card's name and power limit.

It needs two CUDA devices and ``nvcc``, and fails without them.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

MAX_EVENTS = 128  # stamps a member block keeps (code, ns) pairs
STAGES = {1: "entry", 2: "ready raised", 3: "ready seen", 4: "data seen", 5: "flag raised",
          6: "final seen", 7: "exit"}

# (anchor, text put after it) in csrc/ring.cu
PATCHES = [
    ("""__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
""", f"""
__device__ unsigned long long g_stamp[kMaxMembers][2 * {MAX_EVENTS}];
__device__ int g_count[kMaxMembers];
// thread `t` of member d's block 0 stamps a stage
__device__ __forceinline__ void stamp(int d, int b, int code, int t) {{
  if (b == 0 && threadIdx.x == t) {{
    const int i = atomicAdd(&g_count[d], 1);
    if (i < {MAX_EVENTS}) {{
      g_stamp[d][2 * i] = code;
      g_stamp[d][2 * i + 1] = now_ns();
    }}
  }}
}}
"""),
    ("""  const unsigned long long* mine = a.flags[me] + (long long)d * a.blocks + b;
""", """  stamp(d, b, 1, 0);
"""),
    ("""    st_release<true>(a.flags[a.card[ro.left]] + kDataWords + me * kMaxMembers + d, a.base + 1);
""", """  if (remote_in) stamp(d, b, 2, 0);
"""),
    ("""              if (!own) spin<kSys>(mine, want);
""", """              if (!own) stamp(d, b, 4, 32);
"""),
    ("""              if (ready) spin<true>(ready, a.base + 1);
""", """              if (ready) stamp(d, b, 3, 32);
"""),
    ("""            st_release<kSys>(theirs, a.base + u * nseg + j + 1);
""", """            stamp(d, b, 5, 0);
"""),
    ("""  if (remote_in) wait_flag<true>(mine, a.base + units * nseg);  // every segment has landed
""", """  if (remote_in) stamp(d, b, 6, 0);
  stamp(d, b, 7, 0);
"""),
]

READER = f"""
// the probe's reader: member d's stamps on the current card, then zeroed
extern "C" int dla_ring_stamps(unsigned long long* out, int* counts) {{
  cudaError_t e = cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(counts, g_count, sizeof(g_count));
  static int zero[kMaxMembers];
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_count, zero, sizeof(zero));
  return (int)e;
}}
"""


def patched_source(text: str) -> str:
    """ring.cu with the stamps; raises where an anchor is missing."""
    for anchor, extra in PATCHES:
        if text.count(anchor) != 1:
            raise RuntimeError(f"ring_stages_probe: the anchor {anchor.strip()[:60]!r} is not "
                               "in csrc/ring.cu once: the kernel's code moved")
        text = text.replace(anchor, anchor + extra)
    return text + READER


def build(tmp: Path) -> ctypes.CDLL:
    from dla_tpu_torch.kernels import _build

    src = tmp / "ring_stages.cu"
    src.write_text(patched_source((_build.CSRC / "ring.cu").read_text()))
    out = tmp / "ring_stages.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stderr}")
    return ctypes.CDLL(str(out))


def read_stamps(lib, cards, ndev: int) -> list:
    """[(member, [(code, ns), ...])] from every card, zeroing the counts."""
    fn = lib.dla_ring_stamps
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
    buf = (ctypes.c_ulonglong * (128 * 2 * MAX_EVENTS))()
    counts = (ctypes.c_int * 128)()
    out = {}
    for c in sorted(set(cards), key=lambda c: c.index):
        with torch.cuda.device(c):
            torch.cuda.synchronize()
            err = fn(buf, counts)
        if err:
            raise RuntimeError(f"reading the stamps on {c}: CUDA error {err}")
        for d in range(ndev):
            if cards[d] == c and counts[d]:
                n = min(counts[d], MAX_EVENTS)
                base = d * 2 * MAX_EVENTS
                out[d] = [(int(buf[base + 2 * i]), int(buf[base + 2 * i + 1])) for i in range(n)]
    return sorted(out.items())


def main(argv=None) -> int:
    from dla_tpu_torch.bench.df64_packed_probe import _card
    from dla_tpu_torch.kernels import collectives as C

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=1024)
    ap.add_argument("--gather", action="store_true")
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("ring_stages_probe: needs two CUDA devices", file=sys.stderr)
        return 1
    tag = f"[{_card()}]"
    cards = tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    ndev, n, root = len(cards), 1024, 1
    xs = [torch.randn(args.m, n, device=c, dtype=torch.float64) for c in cards]
    outs = [x.new_empty(((ndev if args.gather else 1) * args.m, n)) for x in xs]
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(Path(tmp))
        fn = C._bind(lib.dla_ring_launch)
        lib.dla_ring_enable_peer.argtypes = [ctypes.c_int, ctypes.c_int]
        rec = C._record(cards, xs[0].numel() * 8, gather=args.gather, group=ndev,
                        root=0 if args.gather else root, flags={})
        for a, b in sorted(rec.pairs):
            if lib.dla_ring_enable_peer(a, b):
                raise RuntimeError(f"peer access {a} -> {b} failed")

        def call():
            err = C._call(fn, rec, xs, outs)
            if err:
                raise RuntimeError(f"CUDA error {err}")
        kind = "all_gather" if args.gather else f"broadcast root={root}"
        print(f"ring_stages_probe: {kind} across {ndev} cards, {args.m}x{n} fp64 a member, "
              f"{rec.plan} {tag}", flush=True)
        for _ in range(3):  # warm-up
            call()
        read_stamps(lib, cards, ndev)
        call()
        for d, events in read_stamps(lib, cards, ndev):
            t0 = events[0][1]
            print(f"  one call, member {d} on {cards[d]}: "
                  + ", ".join(f"{STAGES[c]} {(t - t0) / 1e3:.1f}" for c, t in events)
                  + f" us {tag}", flush=True)
        for c in cards:
            with torch.cuda.device(c):
                torch.cuda._sleep(50_000_000)
        for _ in range(args.calls):
            call()
        for d, events in read_stamps(lib, cards, ndev):
            entries = [i for i, (c, _) in enumerate(events) if c == 1]
            periods = [events[j][1] - events[i][1] for i, j in zip(entries, entries[1:])]
            splits = []
            for i, j in zip(entries, entries[1:] + [len(events)]):
                call_ev = events[i:j]
                t0 = call_ev[0][1]
                first = {}
                for c, t in call_ev:
                    first.setdefault(c, t - t0)
                splits.append(first)
            mean = lambda v: sum(v) / max(len(v), 1) / 1e3  # noqa: E731
            keys = sorted({k for s in splits for k in s} - {1})
            print(f"  {args.calls} calls queued, member {d} on {cards[d]}: period between "
                  f"entries {mean(periods):.1f} us (of {[round(p / 1e3, 1) for p in periods]}); "
                  f"mean from entry: "
                  + ", ".join(f"{STAGES[k]} {mean([s[k] for s in splits if k in s]):.1f}"
                              for k in keys) + f" us {tag}", flush=True)
        ref = (C.ring_all_gather_plain(xs) if args.gather else C.ring_broadcast_plain(xs, root))
        same = all(torch.equal(o.view(torch.int64), r.view(torch.int64))
                   for o, r in zip(outs, ref))
        print(f"ring_stages_probe: the plain version's bits: {same} {tag}", flush=True)
        return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
