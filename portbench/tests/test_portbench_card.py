"""On the card: one short run of a one-card cell through the command the
driver runs, its last line the result. Skips where there is no card (decided
inside the test)."""

import json
import subprocess
import sys

import pytest

from portbench import spec


@pytest.mark.gpu
def test_a_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "dpotrf_fp64_n24576.factor", "--seed", str(2**31 + 5), "--seconds", "2",
                        "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert set(r["metrics"]) == {"factor_tflops", "setup_s"}


def test_without_a_card_there_is_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "dpotrf_fp64_n24576.factor", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
