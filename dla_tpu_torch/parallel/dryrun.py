"""The ring planes of the JAX package's multi-device dry run
(``__graft_entry__.dryrun_multichip``, planes 2, 3 and 6) on a flat mesh of D
members that share one device:

    python -m dla_tpu_torch.parallel.dryrun --ndev 4                    # on the card
    python -m dla_tpu_torch.parallel.dryrun --ndev 4 --device cpu --n 256 --nb 16

Each plane factors a seeded ``plgsy`` matrix (the JAX function's seeds), gates
the factor with ``residual_potrf`` below 1e-10 in fp64 (hi + lo in fp64 for
df64) and prints one line, as the JAX function does. Defaults as there:
nb = 8, N = 2·nb·D. The block-cyclic, POTRS and serving planes (1, 4, 5) wait
for their slice.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, NamedTuple

import torch

GATE = 1e-10

#: kind -> (what it is, the JAX dry run's seed)
PLANES = {
    "column": ("column-cyclic", 7),
    "packed": ("PACKED column-cyclic, ~n^2/2D resident", 3),
    "df64": ("packed DF64 pair — emulated-fp64 arithmetic under sharding", 17),
}


class Plane(NamedTuple):
    """One plane's steps: the fp64 matrix from its seed (on the members'
    device), the sharded input made from it, the factorization (in place),
    and the factor as a dense fp64 lower triangle."""

    matrix: Callable[[], torch.Tensor]
    shard: Callable[[torch.Tensor], object]
    factor: Callable[[object], object]
    dense: Callable[[object], torch.Tensor]


def plane(kind: str, n: int, nb: int, mesh, **df64_kw) -> Plane:
    from dla_tpu_torch import parallel as TP
    from dla_tpu_torch.ops import plgsy
    from dla_tpu_torch.ops.df64 import to_df64

    seed = PLANES[kind][1]

    def matrix():
        return plgsy(n, seed=seed, dtype=torch.float64, device=mesh.devices[0])

    if kind == "column":
        return Plane(matrix, lambda a: TP.from_dense_cols(a, nb, mesh),
                     lambda x: TP.potrf_column_cyclic_ring(x, nb, mesh),
                     lambda lx: torch.tril(TP.to_dense_cols(lx, nb, mesh)))
    if kind == "packed":
        return Plane(matrix, lambda a: TP.pack_cols_packed(a, nb, mesh),
                     lambda x: TP.potrf_packed_cyclic(x, n, nb, mesh),
                     lambda lx: TP.unpack_cols_packed(lx, n, nb, mesh))

    def shard(a):
        return tuple(TP.pack_cols_packed(p, nb, mesh) for p in to_df64(a))

    return Plane(matrix, shard,
                 lambda x: TP.potrf_packed_cyclic_df64(*x, n, nb, mesh, **df64_kw),
                 lambda lx: (TP.unpack_cols_packed(lx[0], n, nb, mesh).double()
                             + TP.unpack_cols_packed(lx[1], n, nb, mesh).double()))


def gate(kind: str, a: torch.Tensor, l: torch.Tensor) -> float:
    """``residual_potrf`` of the factor; raises unless it is below 1e-10."""
    from dla_tpu_torch.validate import residual_potrf

    res = float(residual_potrf(a, l, assume_symmetric=True))
    if not res < GATE:  # NaN fails too
        raise RuntimeError(f"{kind} plane: residual {res:.3e} not below the fp64 gate {GATE:g}")
    return res


def run_plane(kind: str, n: int, nb: int, mesh) -> float:
    """Factor the plane's matrix on ``mesh`` and gate it; returns the residual."""
    p = plane(kind, n, nb, mesh)
    a = p.matrix()
    return gate(kind, a, p.dense(p.factor(p.shard(a))))


def main(argv=None) -> int:
    from dla_tpu_torch.parallel import make_flat_mesh

    ap = argparse.ArgumentParser(description="The ring planes on a flat mesh of members")
    ap.add_argument("--ndev", type=int, default=8, help="members of the flat mesh")
    ap.add_argument("--nb", type=int, default=8)
    ap.add_argument("--n", type=int, default=None, help="default 2·nb·ndev")
    ap.add_argument("--device", default="cuda", help="where the members live (default: the card)")
    args = ap.parse_args(argv)
    d, nb = args.ndev, args.nb
    n = args.n or 2 * nb * d
    mesh = make_flat_mesh(d, device=args.device)
    for kind, (what, _) in PLANES.items():
        res = run_plane(kind, n, nb, mesh)
        print(f"dryrun OK: mesh 1x{d} on {mesh.devices[0]} ({what}, ring_broadcast), N={n}, "
              f"NB={nb}, residual {res:.2e} (fp64 gate 1e-10)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
