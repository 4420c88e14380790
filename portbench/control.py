"""Readings for a cell's limits: the program's compared number on many
seeds, and its control's, each through the same window and check as a run,
in one process (set-up paid once for the kernel library), without the
warm-up, which changes no answer.

    python3 portbench/control.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--seconds 1] [--compare-all]

The control is the program with its own path one precision below the
configuration's switched on (the configuration's ``control``). The
benchmark's runs never run it. ``--compare-all`` compares every answer of
a short window of queries, as many as a full run samples, where a run
compares one in ``sample_every``. Prints one JSON line for each seed.
"""

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(ROOT / "build" / "portbench" / "cache" / _sub)
os.environ["OMP_NUM_THREADS"] = "1"  # one process, few threads: a steadier host
sys.path[0] = str(ROOT)

from portbench import bench, spec  # noqa: E402


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--compare-all", action="store_true")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(spec.load_benchmark(), args.workload)
    if args.compare_all:
        cell = dataclasses.replace(cell, traffic=dict(cell.traffic, sample_every=1))
    runs = [(s, False) for s in _seeds(args.seeds)] + [(s, True) for s in _seeds(args.control_seeds)]
    for seed, control in runs:
        r = bench.execute(cell, seed, args.seconds, False, control=control, warm=False)
        print(json.dumps({"workload": cell.name, "seed": seed, "control": control,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "failed": r["failed"], "checks": r["checks"],
                          "metrics": r["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
