"""One process of a sharded serving job across processes: joins the
``torch.distributed`` group (``dla_tpu_torch.parallel.multihost.initialize``),
factors and inverts ``plgsy(n, seed=51)`` on its own device (A⁻¹, the same
global matrix on every process), then answers ``--queries`` blocks of nrhs
right-hand sides with ``solve_inverse_sharded`` on a flat mesh of
``--nproc`` × ``--members`` members, each process computing its own
members' rows. Run one per process, all with the same flags but ``--pid``::

    python tests/torch_serving_child.py --coordinator 127.0.0.1:29500 --nproc 2 \\
        --pid 0 --members 2 --n 256 --nrhs 3 --dtype float64 --device cpu

Each process prints one ``[serve i]`` line: the ms a query block, and its
boundary broadcasts (count, MB, ms, share of the queries' time). Process 0
also prints the residual ``||B - A X|| / (||A|| ||X||)`` against the solve
gate (1e-10 in fp64, N·2e-6 in fp32), and with ``--compare`` the same
queries on a mesh of all the members in this one process: its ms and
whether X has its bits. ``--save DIR`` writes each process's X as
``DIR/x<pid>.npy``. Imports only the port.
"""

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the repository's root

from dla_tpu_torch.algos import potrf_blocked, potri  # noqa: E402
from dla_tpu_torch.ops import plgsy  # noqa: E402
from dla_tpu_torch.parallel import FlatMesh, member_comm, multihost, sharded_apply  # noqa: E402
from dla_tpu_torch.parallel import make_serving_mesh, solve_inverse_sharded  # noqa: E402
from dla_tpu_torch.validate import residual_posv  # noqa: E402


def _queries(apply, rows, b, count, sync):
    """X of the last of ``count`` applies, ms a query block, boundary moved."""
    x = apply(rows, b)  # warm-up
    sync()
    before = dict(member_comm.boundary)
    t0 = time.perf_counter()
    for _ in range(count):
        x = apply(rows, b)
    sync()
    ms = (time.perf_counter() - t0) * 1e3 / count
    return x, ms, {k: member_comm.boundary[k] - before[k] for k in before}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="serving-child")
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--members", type=int, default=1, help="members per process")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--nrhs", type=int, default=3)
    ap.add_argument("--dtype", default="float64", choices=["float32", "float64"])
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    ap.add_argument("--timeout", type=float, default=60.0)
    ap.add_argument("--queries", type=int, default=1)
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--save", default=None)
    args = ap.parse_args(argv)

    cuda = args.device == "cuda"
    card = None
    if cuda:
        card = [args.pid % torch.cuda.device_count()] if args.backend == "nccl" else [0]
    multihost.initialize(args.coordinator, args.nproc, args.pid, card, backend=args.backend,
                         timeout=args.timeout)
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
    dtype = getattr(torch, args.dtype)
    n, size = args.n, args.nproc * args.members

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    a = plgsy(n, seed=51, dtype=dtype, device=dev)
    ainv = potri(potrf_blocked(a, nb=min(512, n)))
    b = torch.from_numpy(np.random.default_rng(5).standard_normal((n, args.nrhs))).to(dev, dtype)
    mesh = make_serving_mesh(size, device=dev)
    if mesh.processes != args.nproc or mesh.per_process != args.members:
        raise SystemExit(f"expected {args.nproc}x{args.members} members, got "
                         f"{mesh.processes}x{mesh.per_process}")
    x = solve_inverse_sharded(ainv, b, mesh)
    rows = [blk if mesh.is_local(m) else None for m, blk in enumerate(ainv.split(n // size))]
    again, ms, crossed = _queries(sharded_apply(mesh), rows, b, args.queries, sync)
    if not torch.equal(again, x):
        raise SystemExit("a repeated query gave other bits")
    share = 100 * crossed["seconds"] * 1e3 / args.queries / ms
    print(f"[serve {args.pid}] {args.nproc} processes x {args.members} members on {dev}, backend "
          f"{args.backend}: n={n} nrhs={args.nrhs} {args.dtype}: {ms:.3f} ms a query block over "
          f"{args.queries}; boundary {crossed['calls'] // args.queries} broadcasts, "
          f"{crossed['bytes'] / args.queries / 1e6:.3f} MB, "
          f"{crossed['seconds'] * 1e3 / args.queries:.3f} ms a query block ({share:.1f}%)",
          flush=True)
    if args.save:
        np.save(os.path.join(args.save, f"x{args.pid}.npy"), x.cpu().numpy())
    rc = 0
    if args.pid == 0:
        res = float(residual_posv(a, b, x, assume_symmetric=True))
        gate = 1e-10 if dtype == torch.float64 else n * 2e-6
        ok = res < gate
        rc |= not ok
        print(f"[serve 0] ||B - AX|| / (||A|| ||X||) = {res:.3e} (gate {gate:g}) "
              f"{'PASS' if ok else 'FAIL'}", flush=True)
        if args.compare:
            one = FlatMesh((dev,) * size)
            one_rows = list(ainv.split(n // size))
            x1, ms1, _ = _queries(sharded_apply(one), one_rows, b, args.queries, sync)
            print(f"[serve 0] in one process on {size} members: {ms1:.3f} ms a query block; "
                  f"the same bits: {bool(torch.equal(x1, x))}", flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return int(rc)


if __name__ == "__main__":
    sys.exit(main())
