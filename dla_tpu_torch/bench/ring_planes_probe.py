"""Where the flat-mesh ring planes' time goes, on one GPU or over the cards.

    python -m dla_tpu_torch.bench.ring_planes_probe [--n 16384] [--nb 1024] [--ndev 4]
        [--spread]

For each plane (dense column-cyclic fp64, packed column-cyclic fp64, packed
column-cyclic df64; ``dla_tpu_torch.parallel.dryrun.plane``), on a mesh of
``--ndev`` members on the card (``--spread``: over every visible card, by
``member_comm.place``'s rule): one factorization as a warm-up, then one
``torch.profiler`` pass over another (the factorization alone, its input made
and sharded before), printing its wall time, the device's busy and idle share
of it, and the device time by kernel name (the largest ten), with the card's
name and power limit; with ``--spread`` all of that for each card, and the
ring kernel's share of each card's device time. The ring kernel is
``ring_kernel`` of ``csrc/ring.cu``.

It needs a CUDA device and fails without one (``--spread``: two).
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from dla_tpu_torch.bench.df64_packed_probe import _card


def _sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def device_split(name: str, run, tag: str, by_card: bool = False) -> None:
    """One ``torch.profiler`` pass over ``run()``: its wall time, the device's
    busy and idle share of it, and the device time by kernel name (the
    largest ten); ``by_card``: for each card apart, with the ring kernel's
    share of its device time."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    _sync_all()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        _sync_all()
        wall = time.perf_counter() - t0
    by_name: dict[tuple, list[int]] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            acc = by_name.setdefault((ev.device_index if by_card else None, ev.name), [0, 0])
            acc[0] += ev.time_range.elapsed_us()
            acc[1] += 1
    if not by_name:
        raise RuntimeError("the profiler recorded no device time")
    print(f"{name}: wall {wall * 1e3:.1f} ms (under the profiler) {tag}", flush=True)
    for card in sorted({c for c, _ in by_name}, key=lambda c: -1 if c is None else c):
        rows = [(us, count, key) for (c, key), (us, count) in by_name.items() if c == card]
        busy = sum(r[0] for r in rows) / 1e6
        ring = sum(r[0] for r in rows if "ring_kernel" in r[2]) / 1e6
        where = "device" if card is None else f"cuda:{card}"
        print(f"  {where}: busy {busy * 1e3:.1f} ms = {100 * busy / wall:.2f}%, idle "
              f"{100 * (1 - busy / wall):.2f}%; ring_kernel {ring * 1e3:.3f} ms = "
              f"{100 * ring / busy:.2f}% of its device time {tag}", flush=True)
        for us, count, key in sorted(rows, reverse=True)[:10]:
            print(f"    {100 * us / 1e6 / busy:6.2f}% of device time  {us / 1e3:10.1f} ms  "
                  f"{count:6d} calls  {key[:90]}", flush=True)


def profile(name: str, p, tag: str, by_card: bool = False) -> None:
    p.factor(p.shard(p.matrix()))  # warm-up: library handles, the kernel library, the allocator
    x = p.shard(p.matrix())
    device_split(name, lambda: p.factor(x), tag, by_card)


def main(argv=None) -> int:
    from dla_tpu_torch.parallel import dryrun, make_flat_mesh

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--nb", type=int, default=1024)
    ap.add_argument("--ndev", type=int, default=4)
    ap.add_argument("--spread", action="store_true", help="the members over every visible card")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available() or (args.spread and torch.cuda.device_count() < 2):
        print("ring_planes_probe: no CUDA device" + (" (--spread needs two)" if args.spread
                                                    else ""), file=sys.stderr)
        return 1
    tag = f"[{_card()}]"
    # one card: its profile; --spread: the placement rule over every visible card
    mesh = make_flat_mesh(args.ndev) if args.spread else make_flat_mesh(args.ndev, device="cuda")
    for kind, (what, _) in dryrun.PLANES.items():
        profile(f"{kind} plane ({what}) N={args.n} nb={args.nb} D={args.ndev} on "
                f"{dryrun.where(mesh)}", dryrun.plane(kind, args.n, args.nb, mesh), tag,
                args.spread)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
