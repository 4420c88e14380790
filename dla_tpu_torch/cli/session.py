"""Distributed factorization "session" CLI — counterpart of
``dla_tpu/cli/session.py``, the ArmoniK-client parity driver.

Ported so far: :func:`dag_counts`, the task counts of the right-looking tile
DAG (POTRF(k,k) → TRSM(i,k) → SYRK(i,i)/GEMM(i,j,k),
``client_distrib.cpp:506-565``), and :func:`parse_args`, the reference's
parameter surface. The session itself runs the block-cyclic multi-device
factorization, which is not ported yet: :func:`main` says so and returns 2.
It does not run another algorithm in its place.
"""

from __future__ import annotations

import argparse
import sys


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
    parse_args(argv)
    print("[CLIENT] the block-cyclic multi-device factorization (dla_tpu/parallel/) is not "
          "ported to dla_tpu_torch yet (ROADMAP.md); the session runs nothing in its place",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
