"""Run one cell of ``BENCHMARK.json`` once, on the machine it starts on:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Every cache the run may fill lies in the
checkout, at a fixed path under ``build/``; the program's own kernel library
is built there too (``build/dla_tpu_torch/``). Without a CUDA card, or with
fewer cards than the cell asks for, it prints no result and exits non-zero.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(ROOT / "build" / "portbench" / "cache" / _sub)
os.environ["OMP_NUM_THREADS"] = "1"  # one process, few threads: a steadier host
# the checkout's root in place of this folder: the program, and this folder
# as the package portbench (its modules never shadow the standard library's)
sys.path[0] = str(ROOT)

from portbench import bench  # noqa: E402

if __name__ == "__main__":
    sys.exit(bench.main())
