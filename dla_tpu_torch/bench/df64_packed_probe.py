"""Where the packed df64 path's time goes, and what its gates read, on one GPU.

    python -m dla_tpu_torch.bench.df64_packed_probe [--n 40960] [--nb 1024]
        [--profile-n 16384] [--no-gates]

Two measurements, each printed with the card's name and power limit:

1. one ``torch.profiler`` pass over a ``potrf_packed_df64`` factorization of
   ``plgsy_packed(profile_n, nb, seed=51)`` (lo = 0, ktb = min(512, nb),
   s = 7): wall time, the device's busy and idle share of it, and the device
   time by kernel name (the largest twelve);
2. at ``--n``: one timed factorization with its peak memory, then every gate
   that can certify the factor, each timed: the packed-native streaming
   Freivalds gate (``freivalds_packed_df64``), the dense streaming gates of the
   unpacked pair (``freivalds_potrf_df64`` with A resident,
   ``freivalds_potrf_df64_gen`` with A streamed), the blocked df64 residual
   (``residual_potrf_df64_blocked``, the gate the reference driver takes when
   the unpacked pair fits its budget) and the native fp64 residual of
   hi + lo. The blocked residual is O(n³) in 28 passes and takes the longest.

It needs a CUDA device and fails without one.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import torch


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _fresh_pair(n: int, nb: int, dev):
    from dla_tpu_torch.algos import plgsy_packed

    aph = plgsy_packed(n, nb, bump=float(n), seed=51, device=dev)
    return aph, torch.zeros_like(aph)


def profile(n: int, nb: int, dev, tag: str) -> None:
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from dla_tpu_torch.algos import potrf_packed_df64

    kw = dict(ktb=min(512, nb), s=7)
    potrf_packed_df64(*_fresh_pair(2 * nb, nb, dev), 2 * nb, nb, **kw)  # builds the kernels
    pair = _fresh_pair(n, nb, dev)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        potrf_packed_df64(*pair, n, nb, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels and copies): the operator rows of
    # key_averages() carry their kernels' time a second time
    by_name: dict[str, list[int]] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            acc = by_name.setdefault(ev.name, [0, 0])
            acc[0] += ev.time_range.elapsed_us()
            acc[1] += 1
    rows = [(us, count, name) for name, (us, count) in by_name.items()]
    busy = sum(r[0] for r in rows) / 1e6
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device time")
    print(f"profile N={n} nb={nb}: wall {wall * 1e3:.1f} ms (under the profiler), device busy "
          f"{busy * 1e3:.1f} ms = {100 * busy / wall:.2f}%, idle {100 * (1 - busy / wall):.2f}% "
          f"{tag}")
    for us, count, key in sorted(rows, reverse=True)[:12]:
        print(f"  {100 * us / 1e6 / busy:6.2f}% of device time  {us / 1e3:10.1f} ms  "
              f"{count:6d} calls  {key[:90]}")


def gates(n: int, nb: int, dev, tag: str, with_gates: bool) -> None:
    import dla_tpu_torch as T
    from dla_tpu_torch.algos import (
        freivalds_potrf_df64,
        potrf_packed_df64,
        residual_potrf_df64_blocked,
    )
    from dla_tpu_torch.algos.potrf_df64 import freivalds_packed_df64, freivalds_potrf_df64_gen
    from dla_tpu_torch.kernels import df64_tiles

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    pair = _fresh_pair(n, nb, dev)
    torch.cuda.reset_peak_memory_stats()
    before = df64_tiles.packed_launches
    (lph, lpl), dt = timed(lambda: potrf_packed_df64(*pair, n, nb, ktb=min(512, nb), s=7))
    print(f"potrf_packed_df64 N={n} nb={nb} s=7: {dt * 1e3:.1f} ms = "
          f"{n**3 / 3 / dt / 1e9:.2f} GFLOP/s, {df64_tiles.packed_launches - before} kernel "
          f"launches, pair {2 * lph.numel() * 4 / 1e9:.2f} GB, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB {tag}")
    if not with_gates:
        return
    fp, t = timed(lambda: freivalds_packed_df64(lph, lpl, n, nb, gen_seed=51, s=7))
    print(f"freivalds_packed_df64 (packed-native, A streamed): {fp:.3e} in {t:.1f} s {tag}")
    lh, ll = T.unpack_tri(lph, n, nb), T.unpack_tri(lpl, n, nb)
    del lph, lpl, pair
    a = T.plgsy(n, bump=float(n), seed=51, device=dev)
    fg, t = timed(lambda: freivalds_potrf_df64_gen(lh, ll, gen_seed=51, s=7))
    print(f"freivalds_potrf_df64_gen (dense pair, A streamed): {fg:.3e} in {t:.1f} s {tag}")
    fd, t = timed(lambda: float(freivalds_potrf_df64(lh, ll, a, None, s=7)))
    print(f"freivalds_potrf_df64 (dense pair, A resident): {fd:.3e} in {t:.1f} s {tag}")
    rb, t = timed(lambda: residual_potrf_df64_blocked(a, None, lh, ll, s=7, rc=2048))
    print(f"residual_potrf_df64_blocked (rc=2048): {rb:.3e} in {t:.1f} s {tag}")
    l64 = lh.double()
    l64 += ll
    del lh, ll
    r64, t = timed(lambda: float(T.residual_potrf(a, l64, assume_symmetric=True,
                                                  assume_tril=True, row_chunk=4096)))
    print(f"native fp64 ||A - LL^T||_inf / ||A||_inf of hi + lo: {r64:.3e} in {t:.1f} s {tag}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=40960, help="0 skips the factorization and gates")
    ap.add_argument("--nb", type=int, default=1024)
    ap.add_argument("--profile-n", type=int, default=16384, help="0 skips the profile")
    ap.add_argument("--no-gates", action="store_true", help="time the factorization only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("df64_packed_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    tag = f"[{_card()}]"
    if args.profile_n:
        profile(args.profile_n, args.nb, dev, tag)
    if args.n:
        gates(args.n, args.nb, dev, tag, not args.no_gates)
    return 0


if __name__ == "__main__":
    sys.exit(main())
