"""Where the block-cyclic plane's time goes, on one GPU.

    python -m dla_tpu_torch.bench.block_cyclic_probe [--n 32768] [--nb 512] [--p 2] [--q 4]

On a p×q member mesh on the card, fp64 (``generate_spd_block_cyclic``, seed
51): ``potrf_block_cyclic`` (the program the layout picks) and ``potrs_block_cyclic`` with ``--nrhs`` right-hand sides. Each is run once
as a warm-up, timed twice between two synchronizations, then traced once
with ``torch.profiler``: its wall time under the profiler, the device's busy
and idle share, the device time by kernel name (the largest ten), and the
device time and launches by kind (products, Cholesky, triangular solves,
copies and fills, the rest), with the card's name and power limit.

It needs a CUDA device and fails without one.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from dla_tpu_torch.bench.df64_packed_probe import _card
from dla_tpu_torch.bench.ring_planes_probe import device_split

#: kernel-name fragments (lower case) → kind, first match wins
KINDS = (
    ("potrf", "Cholesky"), ("chol", "Cholesky"),
    ("trsm", "triangular solve"), ("trsv", "triangular solve"),
    ("gemm", "products"), ("cutlass", "products"), ("xmma", "products"),
    ("copy", "copies and fills"), ("fill", "copies and fills"), ("cat", "copies and fills"),
    ("elementwise", "copies and fills"), ("index", "copies and fills"),
)


def kinds(run) -> None:
    """Device time and launches of ``run()`` by kind of kernel."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    acc: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        low = ev.name.lower()
        kind = next((k for frag, k in KINDS if frag in low), "the rest")
        a = acc.setdefault(kind, [0, 0])
        a[0] += ev.time_range.elapsed_us()
        a[1] += 1
    total = sum(v[0] for v in acc.values()) or 1
    for kind, (us, count) in sorted(acc.items(), key=lambda kv: -kv[1][0]):
        print(f"  {kind:18s} {us / 1e3:10.1f} ms  {100 * us / total:6.2f}%  {count:7d} launches",
              flush=True)


def timed(run) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv=None) -> int:
    from dla_tpu_torch import parallel as TP

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=32768)
    ap.add_argument("--nb", type=int, default=512)
    ap.add_argument("--p", type=int, default=2)
    ap.add_argument("--q", type=int, default=4)
    ap.add_argument("--nrhs", type=int, default=64)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("block_cyclic_probe: no CUDA device", file=sys.stderr)
        return 1
    tag = f"[{_card()}]"
    n = args.n
    lay = TP.BlockCyclicLayout(n, args.nb, args.p, args.q)
    mesh = TP.make_mesh(args.p, args.q, device="cuda")  # one card: its profile

    def fresh():
        return TP.generate_spd_block_cyclic(lay, mesh, dtype=torch.float64)

    program = "unrolled" if lay.ntiles <= 64 else "super-stepped"
    name = (f"potrf_block_cyclic N={n} nb={args.nb} {args.p}x{args.q} fp64 "
            f"({lay.ntiles} steps, {program})")
    TP.potrf_block_cyclic(fresh(), lay, mesh)  # warm-up
    for rep in range(2):
        x = fresh()
        dt = timed(lambda: TP.potrf_block_cyclic(x, lay, mesh))
        print(f"{name}: {dt * 1e3:.1f} ms, {n ** 3 / 3 / dt / 1e9:.1f} GFLOP/s (repeat {rep}) "
              f"{tag}", flush=True)
    x = fresh()
    device_split(name, lambda: TP.potrf_block_cyclic(x, lay, mesh), tag)
    x = fresh()
    kinds(lambda: TP.potrf_block_cyclic(x, lay, mesh))

    b = torch.ones(n, args.nrhs, dtype=torch.float64, device=mesh.device)
    TP.potrs_block_cyclic(x, b, lay, mesh)  # warm-up
    dt = timed(lambda: TP.potrs_block_cyclic(x, b, lay, mesh))
    sname = f"potrs_block_cyclic N={n} nrhs={args.nrhs} {args.p}x{args.q}"
    print(f"{sname}: {dt * 1e3:.1f} ms {tag}", flush=True)
    device_split(sname, lambda: TP.potrs_block_cyclic(x, b, lay, mesh), tag)
    kinds(lambda: TP.potrs_block_cyclic(x, b, lay, mesh))
    return 0


if __name__ == "__main__":
    sys.exit(main())
