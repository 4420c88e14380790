"""Where the flat-mesh ring planes' time goes, on one GPU.

    python -m dla_tpu_torch.bench.ring_planes_probe [--n 16384] [--nb 1024] [--ndev 4]

For each plane (dense column-cyclic fp64, packed column-cyclic fp64, packed
column-cyclic df64; ``dla_tpu_torch.parallel.dryrun.plane``), on a mesh of
``--ndev`` members on the card: one factorization as a warm-up, then one
``torch.profiler`` pass over another (the factorization alone, its input made
and sharded before), printing its wall time, the device's busy and idle share
of it, and the device time by kernel name (the largest ten), with the card's
name and power limit. The ring kernel is ``ring_kernel`` of ``csrc/ring.cu``.

It needs a CUDA device and fails without one.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from dla_tpu_torch.bench.df64_packed_probe import _card


def device_split(name: str, run, tag: str) -> None:
    """One ``torch.profiler`` pass over ``run()``: its wall time, the device's
    busy and idle share of it, and the device time by kernel name (the
    largest ten)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict[str, list[int]] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            acc = by_name.setdefault(ev.name, [0, 0])
            acc[0] += ev.time_range.elapsed_us()
            acc[1] += 1
    rows = [(us, count, key) for key, (us, count) in by_name.items()]
    busy = sum(r[0] for r in rows) / 1e6
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device time")
    print(f"{name}: wall {wall * 1e3:.1f} ms (under the profiler), device busy "
          f"{busy * 1e3:.1f} ms = {100 * busy / wall:.2f}%, idle {100 * (1 - busy / wall):.2f}% "
          f"{tag}", flush=True)
    for us, count, key in sorted(rows, reverse=True)[:10]:
        print(f"  {100 * us / 1e6 / busy:6.2f}% of device time  {us / 1e3:10.1f} ms  "
              f"{count:6d} calls  {key[:90]}", flush=True)


def profile(name: str, p, tag: str) -> None:
    p.factor(p.shard(p.matrix()))  # warm-up: library handles, the kernel library, the allocator
    x = p.shard(p.matrix())
    device_split(name, lambda: p.factor(x), tag)


def main(argv=None) -> int:
    from dla_tpu_torch.parallel import dryrun, make_flat_mesh

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--nb", type=int, default=1024)
    ap.add_argument("--ndev", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ring_planes_probe: no CUDA device", file=sys.stderr)
        return 1
    tag = f"[{_card()}]"
    mesh = make_flat_mesh(args.ndev, device="cuda")  # one card: its profile
    for kind, (what, _) in dryrun.PLANES.items():
        profile(f"{kind} plane ({what}) N={args.n} nb={args.nb} D={args.ndev}",
                dryrun.plane(kind, args.n, args.nb, mesh), tag)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
