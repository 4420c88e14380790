"""The projection model's headline rows for H100 meshes — counterpart of the JAX
package's ``benchmarks/projections_r3.py``, ``serving_projection.py`` and
``df64_mesh_projection.py``.

    python -m dla_tpu_torch.bench.projections [--out rows.json]

Pure arithmetic on the figures of ``dla_tpu_torch/parallel/model.py`` and
``serving.py`` (single-card rates measured on one H100, NVLink from the public
spec): it runs on the CPU and needs no card. Every row is a projection, not a
measurement. It prints one JSON object (to ``--out`` where given):

- ``crossover``: :func:`crossover_n` on 2×2, 2×4 and 4×4 meshes at ``high``;
- ``packed``: :func:`packed_crossover` on D=4 and 8 at ``default``, ``bf16``
  (itemsize 2) and ``f64x`` (the (hi, lo) pair, ``planes=2``);
- ``serving``: :func:`project_serving` at N ∈ {16384, 65536}, nrhs ∈
  {1, 128, 1024}, p ∈ {2, 4, 8};
- ``oocore_mesh``: :func:`project_oocore_mesh` at N=262144 (panel 4096) on
  1×1, 2×2, 2×4 and 4×4 meshes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from dla_tpu_torch.parallel import model, serving

CHIP = "h100"
MESHES = ((2, 2), (2, 4), (4, 4))
PACKED = (("default", 4, 1), ("bf16", 2, 1), ("f64x", 4, 2))  # tier, itemsize, planes
PACKED_NDEV = (4, 8)
SERVING_N, SERVING_NRHS, SERVING_P = (16384, 65536), (1, 128, 1024), (2, 4, 8)
OOCORE_N, OOCORE_PANEL = 262144, 4096
OOCORE_MESHES = ((1, 1), (2, 2), (2, 4), (4, 4))


def crossover_rows() -> list[dict]:
    rows = []
    for p, q in MESHES:
        r = model.crossover_n(p, q, chip=CHIP)
        by_n = {c["n"]: c for c in r["curve"]}

        def at(n, key):
            return by_n[n][key] if n in by_n else None

        rows.append({
            "mesh": r["mesh"], "chip": CHIP, "tier": r["tier"], "nb": r["nb"],
            "crossover_n": r["crossover_n"], "n_eff50": r["n_eff50"],
            "n_eff70": r["n_eff70"],
            "speedup_at_65536": at(65536, "speedup"),
            "speedup_at_131072": at(131072, "speedup"),
            "efficiency_at_131072": at(131072, "efficiency"),
            "comm_fraction_at_131072": at(131072, "comm_fraction"),
            "n_max_single": r["curve"][0]["n_max_single"],
        })
    return rows


def packed_rows() -> list[dict]:
    rows = []
    for tier, itemsize, planes in PACKED:
        for ndev in PACKED_NDEV:
            c = model.packed_crossover(ndev, chip=CHIP, tier=tier, itemsize=itemsize,
                                       planes=planes)
            am = c["at_mesh_max"]
            rows.append({
                "ndev": ndev, "chip": CHIP, "tier": tier, "nb": c["nb"],
                "itemsize": itemsize, "planes": planes,
                "crossover_n": c["crossover_n"], "n_eff50": c["n_eff50"],
                "n_eff70": c["n_eff70"], "mesh_max_n": c["mesh_max_n"],
                "gflops_at_mesh_max": am["dist_gflops"],
                "speedup_at_mesh_max": am["speedup"],
                "comm_fraction_at_mesh_max": am["comm_fraction"],
                "single_chip_fits_at_mesh_max": am["single_chip_fits"],
            })
    return rows


def serving_rows() -> list[dict]:
    return [serving.project_serving(n, nrhs, p, chip=CHIP)
            for n in SERVING_N for nrhs in SERVING_NRHS for p in SERVING_P]


def oocore_rows() -> list[dict]:
    return [model.project_oocore_mesh(OOCORE_N, OOCORE_PANEL, p, q, chip=CHIP)
            for p, q in OOCORE_MESHES]


def projections() -> dict:
    return {
        "comment": ("projections, not measurements: single-card rates measured on one "
                    "H100 (dla_tpu_torch/bench/calibrate_model.py), links from NVLink's "
                    "public spec and two named assumptions"),
        "chip": CHIP,
        "spec": dataclasses.asdict(model.CHIPS[CHIP]),
        "crossover": crossover_rows(),
        "packed": packed_rows(),
        "serving": serving_rows(),
        "oocore_mesh": oocore_rows(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the JSON here instead of stdout")
    args = ap.parse_args(argv)
    text = json.dumps(projections(), indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
