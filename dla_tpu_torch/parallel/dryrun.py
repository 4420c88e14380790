"""The JAX package's multi-device dry run (``__graft_entry__.dryrun_multichip``,
all six planes) on meshes of members, spread over the visible cards (the
placement rule of :mod:`~dla_tpu_torch.parallel.member_comm`) or all on one
device:

    python -m dla_tpu_torch.parallel.dryrun --ndev 4                    # over the cards
    python -m dla_tpu_torch.parallel.dryrun --ndev 4 --device cuda:0    # on one card
    python -m dla_tpu_torch.parallel.dryrun --ndev 4 --device cpu --n 256 --nb 16

1. the block-cyclic factorization on the squarest p×q member mesh of ndev
   (``generate_spd_block_cyclic``, seed 51, N = nb·ndev);
2. 3. and 6. the ring planes on a flat mesh of ndev members: column-cyclic,
   packed and packed df64 (``plgsy`` with seeds 7, 3 and 17, N = 2·nb·ndev);
4. the distributed solve from plane 1's factor (3 right-hand sides drawn by
   numpy from seed 5);
5. the row-sharded explicit-inverse apply on a flat mesh of ndev members
   (``plgsy(128, seed=9)``, ``potri(potrf_blocked(·, nb=32))``, 3
   right-hand sides from seed 11).

Each plane is gated at 1e-10 in fp64 (``residual_potrf``, ``residual_posv``
for 4 and 5; hi + lo in fp64 for df64) and prints one line, in the JAX
function's order, with its seeds, sizes and the cards its members lie on.
Each plane's input is made on member 0's device and copied onto each
member's card. ``--n`` sets the ring planes' N
and plane 1's (JAX's default keeps plane 1 at half the ring planes' N).
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, NamedTuple

import numpy as np
import torch

GATE = 1e-10

#: kind -> (what it is, the JAX dry run's seed)
PLANES = {
    "column": ("column-cyclic", 7),
    "packed": ("PACKED column-cyclic, ~n^2/2D resident", 3),
    "df64": ("packed DF64 pair — emulated-fp64 arithmetic under sharding", 17),
}


class Plane(NamedTuple):
    """One plane's steps: the fp64 matrix from its seed (on member 0's
    device), the sharded input made from it (each shard on its member's
    card), the factorization (in place), and the factor as a dense fp64
    lower triangle (on member 0's device)."""

    matrix: Callable[[], torch.Tensor]
    shard: Callable[[torch.Tensor], object]
    factor: Callable[[object], object]
    dense: Callable[[object], torch.Tensor]


def plane(kind: str, n: int, nb: int, mesh, seed: int | None = None, **df64_kw) -> Plane:
    """The ring plane ``kind`` on ``mesh``, its matrix ``plgsy`` of ``seed``
    (by default the dry run's)."""
    from dla_tpu_torch import parallel as TP
    from dla_tpu_torch.ops import plgsy
    from dla_tpu_torch.ops.df64 import to_df64

    seed = PLANES[kind][1] if seed is None else seed

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


def _below_gate(kind: str, res) -> float:
    res = float(res)
    if not res < GATE:  # NaN fails too
        raise RuntimeError(f"{kind} plane: residual {res:.3e} not below the fp64 gate {GATE:g}")
    return res


def gate(kind: str, a: torch.Tensor, l: torch.Tensor) -> float:
    """``residual_potrf`` of the factor; raises unless it is below 1e-10."""
    from dla_tpu_torch.validate import residual_potrf

    return _below_gate(kind, residual_potrf(a, l, assume_symmetric=True))


def run_plane(kind: str, n: int, nb: int, mesh) -> float:
    """Factor the plane's matrix on ``mesh`` and gate it; returns the residual."""
    p = plane(kind, n, nb, mesh)
    a = p.matrix()
    return gate(kind, a, p.dense(p.factor(p.shard(a))))


def solve_gate(kind: str, a: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> float:
    """``residual_posv`` of a solve; raises unless it is below 1e-10."""
    from dla_tpu_torch.validate import residual_posv

    return _below_gate(kind, residual_posv(a, b, x, assume_symmetric=True))


def where(mesh) -> str:
    """The devices that ``mesh``'s members lie on, in member order."""
    return ",".join(str(d) for d in mesh.cards)


def _rhs(n: int, nrhs: int, seed: int, device) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, nrhs))).to(device)


def block_cyclic_planes(n: int, nb: int, ndev: int, device, nrhs: int = 3) -> dict:
    """Planes 1 (factor), 4 (solve from that factor) and 5 (sharded inverse
    apply), their members on ``device`` (None: spread over the cards);
    returns {plane: line}."""
    from dla_tpu_torch import parallel as TP
    from dla_tpu_torch.algos import potrf_blocked, potri
    from dla_tpu_torch.ops import plgsy
    from dla_tpu_torch.parallel.block_cyclic import squarest

    p, q = squarest(ndev)
    layout = TP.BlockCyclicLayout(n=n, nb=nb, p=p, q=q)
    mesh = TP.make_mesh(p, q, device=device)
    x = TP.generate_spd_block_cyclic(layout, mesh, seed=51, dtype=torch.float64)
    a = TP.to_dense(x, layout)
    lx = TP.potrf_block_cyclic(x, layout, mesh)  # in place
    res1 = gate("block-cyclic", a, torch.tril(TP.to_dense(lx, layout)))
    b = _rhs(n, nrhs, 5, mesh.device)
    res4 = solve_gate("solve", a, b, TP.potrs_block_cyclic(lx, b, layout, mesh))
    n5 = 128
    a5 = plgsy(n5, seed=9, dtype=torch.float64, device=mesh.device)
    smesh = TP.make_serving_mesh(ndev, device=device)
    b5 = _rhs(n5, nrhs, 11, mesh.device)
    x5 = TP.solve_inverse_sharded(potri(potrf_blocked(a5, nb=32)), b5, smesh)
    res5 = solve_gate("serving", a5, b5, x5)
    return {
        1: f"dryrun OK: mesh {p}x{q} on {where(mesh)} (block-cyclic, member copies), N={n}, "
           f"NB={nb}, residual {res1:.2e} (fp64 gate 1e-10)",
        4: f"dryrun OK: mesh {p}x{q} on {where(mesh)} (distributed POTRS from the block-cyclic "
           f"factor), N={n}, NRHS={nrhs}, residual {res4:.2e} (fp64 gate 1e-10)",
        5: f"dryrun OK: mesh 1x{ndev} on {where(smesh)} (row-sharded A^-1 serving apply), "
           f"N={n5}, NRHS={nrhs}, residual {res5:.2e} (fp64 gate 1e-10)",
    }


def main(argv=None) -> int:
    from dla_tpu_torch.parallel import make_flat_mesh

    ap = argparse.ArgumentParser(description="The six dry-run planes on meshes of members")
    ap.add_argument("--ndev", type=int, default=8, help="members of each mesh")
    ap.add_argument("--nb", type=int, default=8)
    ap.add_argument("--n", type=int, default=None,
                    help="N of the ring planes and plane 1 (default 2·nb·ndev and nb·ndev)")
    ap.add_argument("--device", default=None,
                    help="one device for every member (default: spread over the cards)")
    args = ap.parse_args(argv)
    d, nb = args.ndev, args.nb
    n = args.n or 2 * nb * d
    mesh = make_flat_mesh(d, device=args.device)
    lines = block_cyclic_planes(args.n or nb * d, nb, d, args.device)
    for plane, (kind, (what, _)) in zip((2, 3, 6), PLANES.items()):
        res = run_plane(kind, n, nb, mesh)
        lines[plane] = (f"dryrun OK: mesh 1x{d} on {where(mesh)} ({what}, ring_broadcast), "
                        f"N={n}, NB={nb}, residual {res:.2e} (fp64 gate 1e-10)")
    for plane in sorted(lines):
        print(lines[plane], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
