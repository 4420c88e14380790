"""Out-of-core POTRF driver — ``dla_tpu/cli/oocore_driver.py`` on PyTorch:
the N ≫ device-memory configuration as a CLI.

The scale regime the reference served with its distributed blob store
(client holds the full matrix, workers hold O(B²) — SURVEY §5.7); here the
matrix lives in host DRAM, a disk memmap, or a panel-blocked O_DIRECT file,
and column panels stream through the card. Resume-able: re-running with the
same ``--matrix`` and ``--progress`` paths picks up at the first unfinished
panel. The flags are the reference's, with ``--platform`` become
``--device``; ``--p``·``--q`` > 1 is the distributed out-of-core path: every
streamed panel split by rows over a P×Q member mesh
(``potrf_outofcore(mesh=...)``), spread over the visible cards with ``--device
cuda``, as the JAX driver's mesh spans ``jax.devices()``, or all on one card
with ``--device cuda:N``. It prints the reference's lines: ``[oocore] …``,
``Elapsed``, ``Performance`` ((1/3)·N³/t, or the flops this process ran when
it resumed), the staging stats (and all of them as one JSON object on an
``[oocore] stats:`` line), each card's peak memory, the Freivalds value and
``PASS``/``FAIL`` against 1e-10 (fp64) or N·2e-7 (fp32); the exit code is 1
on FAIL.

Usage:
    python -m dla_tpu_torch.cli.oocore_driver --n 32768 --panel 4096 --nb 512
    python -m dla_tpu_torch.cli.oocore_driver --n 131072 --panel 4096 --nb 512 \
        --store panel --matrix /scratch/a.bin --ram-cache
    python -m dla_tpu_torch.cli.oocore_driver --n 1024 --panel 256 --nb 64 --device cpu
    python -m dla_tpu_torch.cli.oocore_driver --n 32768 --panel 4096 --nb 512 --p 2 --q 2
    python -m dla_tpu_torch.cli.oocore_driver --n 32768 --p 2 --q 2 --device cuda:0
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dla-oocore-torch")
    ap.add_argument("--n", type=int, required=True)
    ap.add_argument("--panel", type=int, default=4096)
    ap.add_argument("--nb", type=int, default=512)
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    ap.add_argument("--seed", type=int, default=51)
    ap.add_argument("--matrix", default=None, help="disk-backed store path (RAM if omitted)")
    ap.add_argument("--store", default="flat", choices=["flat", "panel"],
                    help="disk layout: 'flat' = square np.memmap; 'panel' = "
                    "panel-blocked lower-triangle-only with O_DIRECT "
                    "sequential I/O (half the bytes, bypasses the page "
                    "cache — the at-scale backend; requires --matrix)")
    ap.add_argument("--progress", default=None, help="resume sidecar JSON path")
    ap.add_argument("--probes", type=int, default=2,
                    help="Freivalds validation probes (0 = skip)")
    ap.add_argument("--orig", default=None,
                    help="disk path for the regenerated-A validation store "
                    "(RAM if omitted; use when 2 matrices exceed host DRAM)")
    ap.add_argument("--ram-cache", action="store_true",
                    help="write-through RAM cache for the panel store: "
                    "reads served from host memory, every write still goes "
                    "to the O_DIRECT file (same durability/resume)")
    ap.add_argument("--bucket", type=int, default=None,
                    help="round streamed panel heights up to a multiple of "
                    "this (panel store only; zero rows, sliced off before "
                    "writeback)")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="disable the double-buffered k-panel prefetch")
    ap.add_argument("--host-blas", action="store_true",
                    help="run the panel algorithm fully in place with direct "
                    "OpenBLAS calls on the host (no device)")
    ap.add_argument("--p", type=int, default=1, help="mesh rows (PxQ device grid)")
    ap.add_argument("--q", type=int, default=1, help="mesh cols — p*q>1 is the "
                    "distributed out-of-core path (panels split by rows over the members)")
    ap.add_argument("--device", type=_device, default="cuda",
                    help="where the panels are updated and factored: cuda (with --p/--q: "
                    "the members spread over the visible cards), cuda:N (one card) or cpu")
    return ap


def _device(text: str) -> str:
    """``cuda``, ``cuda:N`` or ``cpu``."""
    kind, _, index = text.partition(":")
    if kind not in ("cuda", "cpu") or (index and (kind == "cpu" or not index.isdigit())):
        raise argparse.ArgumentTypeError(f"{text!r} is not cuda, cuda:N or cpu")
    return text


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)

    if args.host_blas and (args.bucket or args.p * args.q > 1):
        ap.error("--host-blas excludes --bucket and --p/--q (single-host, in-place)")

    import numpy as np
    import torch

    cuda = args.device.startswith("cuda")
    if not args.host_blas and cuda and not torch.cuda.is_available():
        print("[oocore] --device cuda: no CUDA device is available "
              "(torch.cuda.is_available() is False); use --device cpu or --host-blas",
              file=sys.stderr)
        return 2

    from dla_tpu_torch.runtime.staging import DirectPanelStore, HostTileStore

    dtype = np.float32 if args.dtype == "float32" else np.float64
    n = args.n
    panel_store = args.store == "panel"
    if panel_store and not args.matrix:
        ap.error("--store panel requires --matrix")
    item = np.dtype(dtype).itemsize
    gib = (n * (n + args.panel) // 2 if panel_store else n * n) * item / 2**30
    where = "host (OpenBLAS)" if args.host_blas else (
        torch.cuda.get_device_name(torch.device(args.device)) if cuda else "cpu")
    print(
        f"[oocore] N={n} panel={args.panel} NB={args.nb} dtype={args.dtype} "
        f"store={args.store}:{args.matrix or 'ram'} ({gib:.1f} GiB) device={where}",
        flush=True,
    )
    if panel_store:
        store = DirectPanelStore(n, dtype, path=args.matrix, panel=args.panel,
                                 ram_cache=args.ram_cache)
        if not store.direct:
            print("[oocore] note: filesystem rejected O_DIRECT, buffered I/O", flush=True)
    else:
        store = HostTileStore(n, dtype, path=args.matrix)
    try:
        return _run(args, store, panel_store, dtype)
    finally:
        store.close()


def _run(args, store, panel_store: bool, dtype) -> int:
    """Generate (unless resuming), factor, print the stats, validate; the
    exit code."""
    import numpy as np

    from dla_tpu_torch.algos.oocore import potrf_outofcore
    from dla_tpu_torch.runtime.staging import HostTileStore, freivalds_streaming
    from dla_tpu_torch.utils.flops import gflops, potrf_flops

    n = args.n
    fresh = args.progress is None or not os.path.exists(args.progress)
    if fresh:
        print("[oocore] generating SPD matrix (native, seeded)...", flush=True)
        gen0 = time.perf_counter()
        store.fill_plgsy(seed=args.seed)
        print(f"[oocore] generated in {time.perf_counter() - gen0:.1f}s", flush=True)

    import torch

    from dla_tpu_torch.parallel import member_comm

    mesh, cards = None, [torch.device(args.device)]
    if not args.host_blas and args.p * args.q > 1:
        from dla_tpu_torch.parallel import make_mesh

        # a bare "cuda" spreads the members over the visible cards
        mesh = make_mesh(args.p, args.q, device=None if args.device == "cuda" else args.device)
        cards = mesh.cards
        print(f"[oocore] distributed: panels sharded over a {args.p}x{args.q} mesh on "
              f"{','.join(map(str, cards))}", flush=True)
    cards = [] if args.host_blas else [member_comm.member_device(c) for c in cards
                                       if c.type == "cuda"]
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)

    t0 = time.perf_counter()
    stats = potrf_outofcore(
        store,
        panel=args.panel,
        nb=args.nb,
        progress_path=args.progress,
        prefetch=not args.no_prefetch,
        height_bucket=args.bucket,
        host_blas=args.host_blas,
        mesh=mesh,
        device=None if mesh is not None else args.device,
        on_panel=lambda j, np_: print(
            f"[oocore] panel {j + 1}/{np_} done @ {time.perf_counter() - t0:.1f}s",
            flush=True,
        ),
    )
    t1 = time.perf_counter()
    print(f"Elapsed: {(t1 - t0) * 1e3:.1f} ms")
    npan_total = n // args.panel
    if stats["panels"] < npan_total:
        # resumed run: quote the rate over the flops THIS process executed
        # (sum over its panels of update+factor work), not the full n³/3,
        # which would overstate a resume
        done_before = npan_total - stats["panels"]
        flops_here = 0.0
        for j in range(done_before, npan_total):
            ph = n - j * args.panel
            flops_here += 2.0 * j * ph * args.panel**2 + ph * args.panel**2
        print(
            f"Performance: {gflops(flops_here, t1 - t0):.2f} Gflop/s "
            f"(resumed: {stats['panels']}/{npan_total} panels, "
            f"{flops_here / potrf_flops(n) * 100:.0f}% of the flops, "
            f"this process)"
        )
    else:
        print(f"Performance: {gflops(potrf_flops(n), t1 - t0):.2f} Gflop/s")
    if stats["panels"]:
        gib = 2**30
        print(
            "[oocore] staging: "
            f"in {stats['bytes_in'] / gib:.2f} GiB "
            f"(pack {stats['pack_s']:.1f}s @ "
            f"{stats['bytes_in'] / max(stats['pack_s'], 1e-9) / gib:.2f} GiB/s, "
            f"h2d wait {stats['h2d_wait_s']:.1f}s), "
            f"out {stats['bytes_out'] / gib:.2f} GiB "
            f"(writeback {stats['writeback_s']:.1f}s @ "
            f"{stats['bytes_out'] / max(stats['writeback_s'], 1e-9) / gib:.2f} GiB/s"
            + (f", compute sync {stats['sync_s']:.1f}s" if stats.get("sync_s") else "")
            + ")",
            flush=True,
        )
        print(f"[oocore] stats: {json.dumps(stats)}", flush=True)
    if cards:
        print("[oocore] peak device memory: " + ", ".join(
            f"{c} {torch.cuda.max_memory_allocated(c) / 2**30:.3f} GiB" for c in cards),
            flush=True)

    if not args.probes:
        return 0
    # Regenerate A from the seed for validation (plgsy is deterministic and
    # validation reads only the lower triangles, so no pre-factorization copy
    # of A is needed — validation works the same on fresh runs and after a
    # kill/resume, and peak host memory during the factorization stays at one
    # matrix).
    v0 = time.perf_counter()
    if panel_store:
        # fully streaming: one pass over L + regeneration of A
        print("[oocore] streaming Freivalds validation...", flush=True)
        res = freivalds_streaming(store, seed=args.seed, probes=args.probes)
    else:
        print("[oocore] regenerating A for Freivalds validation...", flush=True)
        with HostTileStore(n, dtype, path=args.orig) as orig:
            orig.fill_plgsy(seed=args.seed)
            res = orig.freivalds_residual(store, probes=args.probes)
    print(f"freivalds ||(A - LL^T)x|| / (||A|| ||x||) = {res:.2e} "
          f"({time.perf_counter() - v0:.1f}s)")
    gate = 1e-10 if dtype == np.float64 else n * 2e-7
    ok = bool(np.isfinite(res) and res < gate)
    print("PASS" if ok else "FAIL", f"(gate {gate:g})", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
