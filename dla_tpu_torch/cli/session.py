"""Distributed factorization "session" CLI — counterpart of
``dla_tpu/cli/session.py``, the ArmoniK-client parity driver:

    python -m dla_tpu_torch.cli.session --N 32768 --B 512 --p 2 --q 4 --dtype d --solve 64
    python -m dla_tpu_torch.cli.session --N 256 --B 32 --p 2 --q 4 --dtype d --platform cpu

Parameter-surface parity with the reference's DAG client
(``client_distrib.cpp``):

- config from env ``CHOLESKY_N`` / ``CHOLESKY_B``, flags ``--N`` / ``--B``,
  or positionals, with fallback-on-invalid parsing (``:41-93``), and an
  optional JSON config file under them (the ``appsettings.json`` analogue,
  ``:329``), layered by :class:`~dla_tpu_torch.utils.config.RunConfig`;
- wave-by-wave logging of the right-looking DAG (POTRF(k,k) → TRSM(i,k) →
  SYRK(i,i)/GEMM(i,j,k), ``:506-565``) with ``[CLIENT]`` tags. The wave loop
  only logs: the factorization is one call of
  :func:`~dla_tpu_torch.parallel.potrf_block_cyclic` on a p×q member mesh.

The matrix is generated tile-locally on its members, the factorization timed
(``Elapsed``, ``Performance`` at (1/3)·N³/t), the residual
``||A − L·Lᵀ||_inf / ||A||_inf`` gated at 1e-10 in fp64 and complex128 (as
the driver's gate; the reference's session gates complex128 at N·2e-7) and
max(1e-10, N·2e-7) otherwise, and ``--solve NRHS`` solves A·X = 1 through
:func:`~dla_tpu_torch.parallel.potrs_block_cyclic` under the same gate. The
exit code is 0 on PASS and 1 on FAIL.

The session runs on the cards; ``--platform cpu`` runs it on the CPU, and
without a card and without that flag it exits 2. The mesh's members spread
over the visible cards (the placement rule of
:mod:`~dla_tpu_torch.parallel.member_comm`: 2×4 on 4 cards puts two members
on each). The auto grid (p·q = 1) counts the cards as JAX counts devices:
one card gives 1×1, several the squarest p×q grid over them, one member per
card. The timed region waits for every card of the mesh before and after.
``--x64`` is accepted for parity: fp64 is native here.
"""

from __future__ import annotations

import argparse
import sys
import time


def dag_counts(nt: int) -> dict[str, int]:
    """Task counts of the right-looking DAG at Nb=nt tiles (the reference's
    N=12,B=4 demo is 3×3 tiles → 10 tasks)."""
    potrf = nt
    trsm = nt * (nt - 1) // 2
    syrk = nt * (nt - 1) // 2
    gemm = nt * (nt - 1) * (nt - 2) // 6
    return {
        "POTRF": potrf,
        "TRSM": trsm,
        "SYRK": syrk,
        "GEMM": gemm,
        "total": potrf + trsm + syrk + gemm,
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="dla-session",
        description="Distributed block-cyclic POTRF session (ArmoniK-client parity)",
    )
    ap.add_argument("--N", type=int, default=None, help="matrix dimension")
    ap.add_argument("--B", type=int, default=None, help="tile size")
    ap.add_argument("--p", type=int, default=None, help="mesh rows")
    ap.add_argument("--q", type=int, default=None, help="mesh cols")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--config", default=None, help="JSON config (appsettings analogue)")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--x64", action="store_true")
    ap.add_argument(
        "--solve", type=int, default=0, metavar="NRHS",
        help="after factoring, solve A·X=B for NRHS right-hand sides "
        "(distributed POTRS)",
    )
    ap.add_argument("positional", nargs="*", help="[N [B]] positional fallback")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    # positional fallback with fallback-on-invalid parsing (client parity)
    pos_n = pos_b = None
    try:
        if len(args.positional) >= 1:
            pos_n = int(args.positional[0])
        if len(args.positional) >= 2:
            pos_b = int(args.positional[1])
    except ValueError:
        print("[CLIENT] invalid positional args ignored", flush=True)

    import torch

    from dla_tpu_torch.utils.config import RunConfig

    if args.platform not in (None, "cpu", "cuda", "gpu"):
        print(f"[CLIENT] --platform {args.platform}: the port runs on cuda or cpu",
              file=sys.stderr)
        return 2
    cpu = args.platform == "cpu"
    if not cpu and not torch.cuda.is_available():
        print("[CLIENT] no CUDA device is available (torch.cuda.is_available() is False); "
              "pass --platform cpu to run the session on the CPU", file=sys.stderr)
        return 2
    cfg = RunConfig.layered(
        json_path=args.config,
        n=args.N if args.N is not None else pos_n,
        nb=args.B if args.B is not None else pos_b,
        seed=args.seed,
        dtype=args.dtype,
        p=args.p,
        q=args.q,
    )
    from dla_tpu_torch.parallel.block_cyclic import squarest

    ncards = 1 if cpu else torch.cuda.device_count()
    auto = cfg.p * cfg.q == 1 and ncards > 1  # the squarest grid over the cards
    p, q = squarest(ncards) if auto else (cfg.p, cfg.q)

    nt = cfg.n // cfg.nb
    counts = dag_counts(nt)
    backend = "cpu" if cpu else f"cuda ({torch.cuda.get_device_name()})"
    print(
        f"[CLIENT] session: N={cfg.n} B={cfg.nb} tiles={nt}x{nt} "
        f"mesh={p}x{q} dtype={cfg.dtype} backend={backend}",
        flush=True,
    )
    print(
        f"[CLIENT] DAG: {counts['POTRF']} POTRF + {counts['TRSM']} TRSM + "
        f"{counts['SYRK']} SYRK + {counts['GEMM']} GEMM = {counts['total']} "
        f"tile tasks (executed by the members in one call — no per-task wait)",
        flush=True,
    )
    for k in range(nt):
        ntrsm = nt - 1 - k
        nupd = ntrsm * (ntrsm + 1) // 2
        print(
            f"[CLIENT] wave k={k}: POTRF({k},{k}); {ntrsm} TRSM; {nupd} SYRK/GEMM",
            flush=True,
        )

    from dla_tpu_torch.parallel import (
        BlockCyclicLayout,
        generate_spd_block_cyclic,
        make_mesh,
        member_comm,
        potrf_block_cyclic,
        to_dense,
    )
    from dla_tpu_torch.utils.flops import gflops, potrf_flops
    from dla_tpu_torch.validate import residual_potrf

    layout = BlockCyclicLayout(n=cfg.n, nb=cfg.nb, p=p, q=q)
    mesh = make_mesh(p, q, device="cpu" if cpu else None)  # spread over the cards
    if not cpu:
        print(f"[CLIENT] members on {','.join(str(d) for d in mesh.cards)}", flush=True)
    dtype = getattr(torch, cfg.dtype)

    def sync():  # every card of the mesh
        member_comm.synchronize(mesh.devices)

    def generate():
        return generate_spd_block_cyclic(layout, mesh, seed=cfg.seed, dtype=dtype)

    print("[CLIENT] generating SPD tiles on their members...", flush=True)
    x = generate()
    sync()
    print("[CLIENT] submitting factorization...", flush=True)
    t0 = time.perf_counter()
    lx = potrf_block_cyclic(x, layout, mesh)  # in place
    sync()
    t1 = time.perf_counter()
    perf = gflops(potrf_flops(cfg.n), t1 - t0)
    print(f"Elapsed: {(t1 - t0) * 1e3:.1f} ms")
    print(f"Performance: {perf:.2f} Gflop/s")

    xs = bmat = None
    if args.solve:
        from dla_tpu_torch.parallel import potrs_block_cyclic

        bmat = torch.ones((cfg.n, args.solve), dtype=dtype, device=mesh.device)
        print(f"[CLIENT] distributed POTRS, nrhs={args.solve}...", flush=True)
        t0 = time.perf_counter()
        xs = potrs_block_cyclic(lx, bmat, layout, mesh)
        sync()
        print(f"[CLIENT] solve elapsed: {(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)

    # the factor densified, then A regenerated on its members: neither is
    # held beside the shards of the other
    l = to_dense(lx, layout).tril_()
    del lx, x
    a = to_dense(generate(), layout)
    chunk = 4096 if cfg.n >= 16384 and cfg.n % 4096 == 0 else None
    res = float(residual_potrf(a, l, assume_symmetric=True, assume_tril=True, row_chunk=chunk))
    print(f"||A - LL^T||_inf / ||A||_inf = {res:.2e}")
    gate = 1e-10 if dtype in (torch.float64, torch.complex128) else max(1e-10, cfg.n * 2e-7)
    ok = res < gate  # False for NaN
    del l

    if args.solve:
        from dla_tpu_torch.validate import residual_posv

        sres = float(residual_posv(a, bmat, xs, assume_symmetric=True))
        print(f"||B - A X||_inf / (||A||_inf ||X||_inf) = {sres:.2e}")
        ok = ok and sres < gate

    print("[CLIENT] session complete:", "PASS" if ok else "FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
