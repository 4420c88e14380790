"""dla_tpu_torch's tiered bench (``python -m dla_tpu_torch.bench.bench``) on
the CPU at a small size, and its tier parser against the reference's."""

import json
import re
from pathlib import Path

import pytest
import torch

from dla_tpu_torch.bench import bench
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = Path(__file__).resolve().parents[1]
SMALL = ("high:inplace:64:64:256,default:packed:64:64:256,highest:shrink:64:32:256,"
         "bf16:packed:64:64:256,f64x:7:64:-:256")
# the keys of the reference's one JSON line (bench.py:677-700)
CLOSING_KEYS = {"metric", "value", "unit", "vs_baseline", "residual", "gflops_raw", "tiers",
                "config"}


def _run(capsys, monkeypatch, tiers, iters="1", **env):
    monkeypatch.setenv("BENCH_PRECISIONS", tiers)
    monkeypatch.setenv("BENCH_ITERS", iters)
    monkeypatch.setenv("BENCH_TB", "64")
    monkeypatch.setenv("BENCH_IB", "32")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rc = bench.main(["--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    return rc, [json.loads(line) for line in out]


def test_one_line_per_tier_then_the_closing_line(capsys, monkeypatch):
    rc, lines = _run(capsys, monkeypatch, SMALL)
    assert rc == 0
    *tiers, closing = lines
    assert [t["tier"] for t in tiers] == ["high_inplace", "default_packed", "highest",
                                          "bf16_default_packed", "f64x"]
    assert set(closing) == CLOSING_KEYS
    assert list(closing["tiers"]) == [t["tier"] for t in tiers]
    gates = {"high_inplace": 256 * 2e-7, "default_packed": 256 * 2e-7, "highest": 256 * 2e-7,
             "bf16_default_packed": 16 * 2e-4, "f64x": 1e-10}
    validation = {"high_inplace": "residual", "default_packed": "freivalds",
                  "highest": "residual", "bf16_default_packed": "freivalds",
                  "f64x": "df64-device-residual"}
    for t in tiers:
        assert t["passed"] and t["device"] == "cpu" and t["n"] == 256 and t["nb"] == 64
        assert t["gate"] == pytest.approx(gates[t["tier"]])
        assert 0 <= t["residual"] < t["gate"]
        assert t["validation"] == validation[t["tier"]]
        assert len(t["times"]) == 1 and t["gflops"] == t["gflops_raw"] > 0
        assert t["gflops"] == pytest.approx(256**3 / 3 / t["times"][0] / 1e9)
        entry = closing["tiers"][t["tier"]]
        assert entry == {k: t[k] for k in ("gflops", "gflops_raw", "residual", "nb", "n",
                                           "validation")}
    head = tiers[0]  # no plain `high` tier: the first is the headline
    assert closing["value"] == head["gflops"] == closing["gflops_raw"]
    assert closing["residual"] == head["residual"] and closing["unit"] == "GFLOP/s"
    assert closing["metric"].startswith("POTRF fp32(high_inplace) N=256 NB=64")
    assert closing["vs_baseline"] == pytest.approx(head["gflops"] / 204.8, rel=1e-3)
    assert closing["config"] == {"panel": "blocktrsm", "trailing": "pallas", "tb": 64,
                                 "kb": 256, "alias": False, "diag_factor": "auto", "ib": 32}


def test_freivalds_gate_where_the_residual_does_not_fit(capsys, monkeypatch):
    rc, lines = _run(capsys, monkeypatch, "high:inplace:128:64:512,bf16:inplace:128:64:512",
                     iters="2", DLA_TPU_VALIDATE_HBM_BUDGET="1")
    assert rc == 0
    for t in lines[:-1]:
        assert t["validation"] == "freivalds" and t["passed"] and len(t["times"]) == 2
        assert t["gflops"] == pytest.approx(512**3 / 3 / max(t["times"]) / 1e9)  # median_high
    assert lines[1]["gate"] == pytest.approx(512**0.5 * 2e-4)


def test_failed_gate_exits_nonzero_after_the_closing_line(capsys, monkeypatch):
    monkeypatch.setattr("dla_tpu_torch.cli.potrf_driver._gate", lambda n, dtype: 1e-30)
    rc, lines = _run(capsys, monkeypatch, "high:inplace:64:64:256")
    assert rc == 1
    assert lines[0]["passed"] is False and set(lines[-1]) == CLOSING_KEYS


def test_budget_skip_is_printed(capsys, monkeypatch):
    rc, lines = _run(capsys, monkeypatch, "high:inplace:64:64:256,highest:shrink:64:32:256",
                     BENCH_BUDGET_S="0")
    assert rc == 0
    assert lines[0]["tier"] == "high_inplace" and lines[0]["passed"]
    assert lines[1]["tier"] == "highest" and lines[1]["skipped"] == "time budget"
    assert list(lines[2]["tiers"]) == ["high_inplace"]


def test_cuda_without_card_fails_and_prints_nothing(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    assert bench.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_default_tiers_are_the_reference_s():
    src = (REPO / "bench.py").read_text()
    m = re.search(r'"BENCH_PRECISIONS",\s*((?:"[^"]*"\s*)+),', src)
    ref_default = "".join(re.findall(r'"([^"]*)"', m.group(1)))
    assert bench.DEFAULT_TIERS == ref_default
    assert bench.BASELINE_GFLOPS == float(re.search(r"BASELINE_GFLOPS = ([\d.]+)", src).group(1))


# what the reference's loop (bench.py:613-659) makes of each default spec, at
# its defaults BENCH_N=32768, BENCH_NB=8192, BENCH_KB=256
PARSED = {
    "high:inplace:1024:1024:61440": dict(key="high_inplace", precision="high",
                                         storage="float32", formulation="inplace", nb=1024,
                                         kb=1024, n=61440),
    "default:packed:4096:4096:81920": dict(key="default_packed", precision="default",
                                           storage="float32", formulation="packed", nb=4096,
                                           kb=4096, n=81920),
    "highest": dict(key="highest", precision="highest", storage="float32",
                    formulation="shrink", nb=8192, kb=256, n=32768),
    "bf16:packed:4096:4096:106496": dict(key="bf16_default_packed", precision="default",
                                         storage="bfloat16", formulation="packed", nb=4096,
                                         kb=4096, n=106496),
    "f64x:7": dict(key="f64x", precision="f64x", storage="df64", slices=7, nb=1024, n=24576),
    "f64x:6:512:-:8192": dict(key="f64x", precision="f64x", storage="df64", slices=6, nb=512,
                              n=8192),
    "bf16:inplace:4096:-": dict(key="bf16_default_inplace", precision="default",
                                storage="bfloat16", formulation="inplace", nb=4096, kb=256,
                                n=32768),
}


@pytest.mark.parametrize("spec", list(PARSED))
def test_parse_tier(spec):
    assert bench.parse_tier(spec, nb=8192, kb=256, n=32768) == PARSED[spec]
    assert spec in PARSED and (spec in bench.DEFAULT_TIERS.split(",") or ":" in spec)
