"""Multi-process distributed POTRF — counterpart of
``dla_tpu/parallel/multihost.py``.

The reference's L4 is inter-node: a gRPC client farms tile tasks to workers
on other machines (``client_distrib.cpp:325-353``). The JAX package joins
every process to ``jax.distributed``, after which ``jax.devices()`` spans
all of them and the same ``shard_map`` programs run SPMD. Here every process
joins one ``torch.distributed`` process group (:func:`initialize`); a mesh
made while the group is up spans its processes, member m on process
``m // per_process`` as ``jax.devices()`` lists process 0's devices first.
Each process runs the same plane functions, unchanged, on its own members
(all on the one device of that process: ``--backend nccl`` gives process
``pid`` card ``pid % device_count``, gloo keeps every process on card 0), and
a block owned by another process arrives by a
broadcast from the owner's process (:mod:`~dla_tpu_torch.parallel.member_comm`):
the planes give the bits they give in one process.

The transport is an explicit choice (``jax.distributed`` makes it by
itself): ``gloo`` on the CPU; ``nccl`` where each process has a card of its
own; ``gloo`` on CUDA tensors where processes share one card, which NCCL
refuses. gloo stages each broadcast of a CUDA tensor through host memory;
the arithmetic stays on the card.

Two entry points:

- :func:`initialize` — join the process group;
- ``python -m dla_tpu_torch.parallel.multihost`` — one process of a demo
  job: ``--nproc`` processes of ``--local-devices`` members each run the
  planes named by ``--plane`` (``block``, ``potrs``, ``column``, ``packed``,
  ``packed-df64``, or several, comma-separated) with the JAX demo's seeds,
  sizes and 1e-10 fp64 gate on process 0::

      python -m dla_tpu_torch.parallel.multihost --coordinator 127.0.0.1:29500 \\
          --nproc 2 --pid 0 --plane block --device cpu      # and --pid 1 beside it

  Each process prints, per plane, the factorization's wall time and rate,
  its boundary broadcasts (count, bytes, seconds), its ``ring_broadcast``
  (#11) launches and its peak device memory. ``--save DIR`` has process 0
  write each plane's assembled factor (the solve for ``potrs``; hi + lo in
  fp64 for ``packed-df64``) to ``DIR/<plane>.npy``; ``--compare`` has it
  run each plane again in one process on a mesh of all the members and
  print that time and the largest difference between the two results.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import time

PLANES = ("block", "potrs", "column", "packed", "packed-df64")


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_ids=None,
    *,
    backend: str | None = None,
    timeout: float | None = None,
) -> None:
    """Join this process to the ``torch.distributed`` process group of
    ``num_processes`` processes whose rendezvous is at
    ``coordinator_address`` (host:port); does nothing if the group is up.

    ``backend``: ``"gloo"`` (the default; the CPU, or processes that share a
    card) or ``"nccl"`` (a card per process). ``local_device_ids``: the
    card this process uses (its first entry). ``timeout`` (seconds) bounds
    the rendezvous and every collective: a process that never joins, or
    dies, fails the others instead of hanging them.
    """
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if local_device_ids:
        torch.cuda.set_device(int(list(local_device_ids)[0]))
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend or "gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kw)


def _gate(a, lfac, what: str) -> int:
    """JAX's gate line on process 0: ||A − L·Lᵀ||_inf / ||A||_inf under 1e-10."""
    from dla_tpu_torch.validate import residual_potrf

    n = a.shape[0]
    chunk = next(c for c in (4096, 2048, 1024, 512, 256, 128, 64, n) if n % c == 0)
    res = float(residual_potrf(a, lfac, assume_symmetric=True, assume_tril=True,
                               row_chunk=min(n, chunk)))
    status = "PASS" if res < 1e-10 else "FAIL"
    print(f"[mh 0] {what} ||A - LL^T||_inf / ||A||_inf = {res:.2e} {status}", flush=True)
    return 0 if status == "PASS" else 1


def _max_difference(a, b) -> float:
    """max |a − b|, 4096 rows at a time (a factor at N=32768 is 8 GiB)."""
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return max(float((a[i : i + 4096] - b[i : i + 4096]).abs().max())
               for i in range(0, a.shape[0], 4096))


#: the JAX demo's seeds: the block-cyclic generator's, and plgsy's per ring plane
SEEDS = {"block": 51, "potrs": 51, "column": 7, "packed": 3, "packed-df64": 13}


def _plane(plane: str, n: int, nb: int, p: int, q: int, mesh_of):
    """The plane's steps on ``mesh_of("block")`` or ``mesh_of("flat")``, as a
    :class:`~dla_tpu_torch.parallel.dryrun.Plane`. Its ``dense`` is the result
    on every process: the factor's lower triangle (hi + lo in fp64 for df64),
    or the solve of 3 right-hand sides for ``potrs``."""
    import numpy as np
    import torch

    from dla_tpu_torch import parallel as TP
    from dla_tpu_torch.parallel import dryrun

    if plane not in ("block", "potrs"):
        kind = "df64" if plane == "packed-df64" else plane
        return dryrun.plane(kind, n, nb, mesh_of("flat"), seed=SEEDS[plane])
    layout, mesh = TP.BlockCyclicLayout(n=n, nb=nb, p=p, q=q), mesh_of("block")
    b = np.random.default_rng(5).standard_normal((n, 3))
    if plane == "potrs":
        dense = lambda lx: TP.potrs_block_cyclic(lx, b, layout, mesh)  # noqa: E731
    else:
        dense = lambda lx: TP.to_dense(lx, layout, mesh).tril_()  # noqa: E731
    return dryrun.Plane(
        lambda: None,
        lambda _: TP.generate_spd_block_cyclic(layout, mesh, seed=SEEDS[plane],
                                               dtype=torch.float64),
        lambda x: TP.potrf_block_cyclic(x, layout, mesh), dense)


def _run(pl, sync):
    """Make the plane's input (untimed), factor it, then take its result:
    (the result, seconds to factor, seconds to take the result, the boundary
    broadcasts of each of those two steps)."""
    from dla_tpu_torch.parallel import member_comm

    def mark():
        sync()
        return dict(member_comm.boundary), time.perf_counter()

    x = pl.shard(pl.matrix())
    (b0, t0) = mark()
    lx = pl.factor(x)
    (b1, t1) = mark()
    out = pl.dense(lx)
    (b2, t2) = mark()
    return (out, t1 - t0, t2 - t1, {k: b1[k] - b0[k] for k in b0},
            {k: b2[k] - b1[k] for k in b1})


def _demo(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dla-multihost-demo")
    ap.add_argument("--coordinator", required=True, help="host:port")
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=4, help="members per process")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--nb", type=int, default=8)
    ap.add_argument("--p", type=int, default=2)
    ap.add_argument("--q", type=int, default=4)
    ap.add_argument("--plane", default="block",
                    help="the distributed planes to run across the processes, comma-separated: "
                         + ", ".join(PLANES))
    ap.add_argument("--device", default="cuda",
                    help="where this process's members live (default: the card)")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"],
                    help="gloo: the CPU, or processes that share a card; nccl: a card each")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds the rendezvous and each collective may wait for the others")
    ap.add_argument("--save", default=None, metavar="DIR",
                    help="process 0 saves each plane's result as DIR/<plane>.npy")
    ap.add_argument("--compare", action="store_true",
                    help="process 0 also runs each plane in one process on all the members")
    args = ap.parse_args(argv)
    planes = args.plane.split(",")
    bad = [pl for pl in planes if pl not in PLANES]
    if bad:
        ap.error(f"unknown plane(s) {bad}; choose from {', '.join(PLANES)}")

    import numpy as np
    import torch
    import torch.distributed as dist

    from dla_tpu_torch import parallel as TP
    from dla_tpu_torch.kernels import collectives
    from dla_tpu_torch.ops import plgsy
    from dla_tpu_torch.parallel import member_comm

    cuda = args.device != "cpu"
    if cuda and not torch.cuda.is_available():
        print(f"[mh {args.pid}] no CUDA device; pass --device cpu", file=sys.stderr)
        return 2
    card = None
    if cuda:
        card = [args.pid % torch.cuda.device_count()] if args.backend == "nccl" else [0]
    initialize(args.coordinator, args.nproc, args.pid, card, backend=args.backend,
               timeout=args.timeout)
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
    ndev = args.nproc * args.local_devices
    pid = args.pid
    print(f"[mh {pid}] {dist.get_world_size()} processes, {ndev} global members "
          f"({args.local_devices} local) on {dev}, backend {args.backend}", flush=True)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def spanning(kind):
        mesh = TP.make_mesh(args.p, args.q, device=dev) if kind == "block" \
            else TP.make_flat_mesh(ndev, device=dev)
        if mesh.size != ndev or mesh.per_process != args.local_devices:
            raise SystemExit(f"expected {args.nproc}x{args.local_devices} global members, got "
                             f"{mesh.processes}x{mesh.per_process}")
        return mesh

    def one_process(kind):
        return TP.MemberMesh((dev,) * (args.p * args.q), (args.p, args.q)) if kind == "block" \
            else TP.FlatMesh((dev,) * ndev)

    rc = 0
    for plane in planes:
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        dist.barrier()
        ring0 = collectives.ring_broadcast_launches
        out, t_factor, t_last, crossed, assembly = _run(
            _plane(plane, args.n, args.nb, args.p, args.q, spanning), sync)
        t_solve = None
        if plane == "potrs":  # the solve is part of the plane; its result needs no assembly
            t_solve, crossed = t_last, {k: crossed[k] + assembly[k] for k in crossed}
            assembly = dict.fromkeys(assembly, 0)
        ring = collectives.ring_broadcast_launches - ring0
        work = t_factor + (t_solve or 0.0)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else 0.0
        solve = "" if t_solve is None else f", solve (nrhs=3) {t_solve * 1e3:.3f} ms"
        print(f"[mh {pid}] plane {plane}: N={args.n} NB={args.nb} over {ndev} members, "
              f"factor {t_factor * 1e3:.3f} ms, {args.n**3 / 3 / t_factor / 1e9:.2f} GFLOP/s"
              f"{solve}; boundary {crossed['calls']} broadcasts, "
              f"{crossed['bytes'] / 1e6:.3f} MB, {crossed['seconds'] * 1e3:.3f} ms "
              f"({100 * crossed['seconds'] / work:.1f}% of the plane); ring_broadcast launches "
              f"{ring}; assembly {assembly['calls']} broadcasts, {assembly['bytes'] / 1e6:.3f} "
              f"MB, {assembly['seconds'] * 1e3:.3f} ms; peak device memory {peak:.3f} GiB",
              flush=True)
        if pid == 0:
            a = plgsy(args.n, seed=SEEDS[plane], dtype=torch.float64, device=dev)
            if plane == "potrs":
                b = torch.from_numpy(np.random.default_rng(5).standard_normal((args.n, 3)))
                res = float((b.to(dev) - a @ out).abs().max()
                            / (a.abs().max() * out.abs().max()))
                status = "PASS" if res < 1e-10 else "FAIL"
                print(f"[mh 0] potrs ||B - AX|| gate = {res:.2e} {status}", flush=True)
                rc |= status != "PASS"
            else:
                what = {"block": "block-cyclic", "column": "column-cyclic ring",
                        "packed": "packed-cyclic ring",
                        "packed-df64": "packed-cyclic DF64 ring"}[plane]
                rc |= _gate(a, out, what)
            del a
            if args.save:
                np.save(os.path.join(args.save, f"{plane}.npy"), out.cpu().numpy())
            if args.compare:
                ref, t1, s1, _, _ = _run(
                    _plane(plane, args.n, args.nb, args.p, args.q, one_process), sync)
                diff = _max_difference(out, ref)
                solve = f", solve {s1 * 1e3:.3f} ms" if plane == "potrs" else ""
                print(f"[mh 0] plane {plane} in one process on {ndev} members: factor "
                      f"{t1 * 1e3:.3f} ms{solve}; max |difference| {diff:.3e}, the same bits: "
                      f"{bool(torch.equal(out, ref))}", flush=True)
                del ref
        del out

    # every process reaches the teardown together
    dist.barrier()
    dist.destroy_process_group()
    return rc


if __name__ == "__main__":
    sys.exit(_demo())
