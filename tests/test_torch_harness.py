"""dla_tpu_torch's sweep harness, plots, profiling helpers and LAPACK oracle,
held against dla_tpu's (``bench/harness.py``, ``bench/plots.py``,
``utils/profiling.py``, ``cli/oracle.py``) on the CPU.

What is compared how:
- the parse contract, the CSV columns, the profile format and the child's
  flags: equal to the JAX harness's (the module and ``--device cpu`` for
  ``--platform cpu`` aside);
- a sweep on ``device cpu``: every row exit code 0 with a gate-passing
  ``rel_error``; a rerun adds nothing; the kb axis and an old-schema CSV as in
  ``tests/test_cli_bench.py``;
- the plots: PNGs written from the harness's CSV and from solve-path rows;
- the profiling helpers: the H100 peaks, the override, the roofline
  arithmetic against JAX's ``Roofline`` given the same peak, a trace file;
- the oracle: JAX's residual line to the printed digit (the same fp64 matrix
  and the same LAPACK call), and a passing cross-check.
"""

import csv
import json
import os

import pytest
import torch

from dla_tpu.bench import harness as JH
from dla_tpu.cli import oracle as jax_oracle
from dla_tpu.utils import profiling as JPF
from dla_tpu_torch.bench import harness as H
from dla_tpu_torch.cli import oracle
from dla_tpu_torch.utils import profiling as PF
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

DRIVER_OUT = (
    "[dla-potrf] N=64 NB=16\nRepeat 0: 3.0 ms 0.03 Gflop/s (warm-up)\n"
    "Repeat 1: 1.5 ms 0.06 Gflop/s\nRepeat 2: 1.25 ms 0.07 Gflop/s\nElapsed: 1.25 ms\n"
    "Performance: 0.07 Gflop/s\n||A - LL^T||_inf / ||A||_inf = 5.46e-16\nPASS\n"
)
FREIVALDS_OUT = ("Elapsed: 12.3 ms\nPerformance: 123.45 Gflop/s\n"
                 "freivalds ||(A - LL^T)x|| / (||A|| ||x||) = 8.96e-07\nPASS\n")


class TestContract:
    @pytest.mark.parametrize("out", [DRIVER_OUT, FREIVALDS_OUT, "no numbers\n"])
    def test_parse_as_jax(self, out):
        assert H.parse_metrics(out) == JH.parse_metrics(out)
        assert H.parse_repeats(out) == JH.parse_repeats(out)

    def test_columns(self):
        assert H.CSV_COLUMNS == JH.CSV_COLUMNS

    def test_jax_profile_runs_unchanged(self, tmp_path):
        prof = {"ns": [1024, 2048], "nbs": [256], "dtypes": ["float32", "complex64"],
                "modes": ["inplace", "distributed"], "meshes": [[2, 2]], "repeats": 3,
                "platform": "cpu", "gen": "gershgorin", "precision": "high", "kb": 128,
                "diag": "twolevel", "timeout_s": 60, "unknown_key": 1}
        path = tmp_path / "p.json"
        path.write_text(json.dumps(prof))
        mine, ref = H.SweepConfig.from_json(str(path)), JH.SweepConfig.from_json(str(path))
        assert {f: getattr(mine, f) for f in mine.__dataclass_fields__} == {
            f: getattr(ref, f) for f in ref.__dataclass_fields__}

    @pytest.mark.parametrize("mode", ["blocked", "shrink", "inplace", "packed", "df64",
                                      "distributed", "masked"])
    @pytest.mark.parametrize("platform", ["cpu", None])
    def test_child_flags_as_jax(self, mode, platform):
        cfg = H.SweepConfig(platform=platform, trailing="pallas", precision="default", kb=64,
                            diag="twolevel", gen="gershgorin")
        jcfg = JH.SweepConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
        mine = H._driver_cmd(cfg, 512, 128, "float32", mode, (2, 2), repeats=3)
        ref = JH._driver_cmd(512, 128, "float32", mode, (2, 2), jcfg.gen, jcfg.platform,
                             jcfg.panel, jcfg.trailing, jcfg.precision, jcfg.diag, 3, kb=jcfg.kb)
        assert mine[1:3] == ["-m", "dla_tpu_torch.cli.potrf_driver"]
        ref = ref[3:]
        if platform == "cpu":  # the JAX driver's --platform cpu is the port's --device cpu
            ref[ref.index("--platform")] = "--device"
        assert mine[3:] == ref


class TestSweep:
    def test_rows_resume_and_gate(self, tmp_path):
        csv_path = str(tmp_path / "bench.csv")
        cfg = H.SweepConfig(ns=(64,), nbs=(16, 32), dtypes=("float64",), repeats=2,
                            platform="cpu", timeout_s=300)
        rows = H.run_sweep(cfg, csv_path, echo=False)
        assert len(rows) == 4  # 2 NBs x 2 repeats
        with open(csv_path) as f:
            rows2 = list(csv.DictReader(f))
        assert len(rows2) == 4 and all(r["exit_code"] == "0" for r in rows2)
        assert all(r["scheduler"] == H.SCHEDULER and r["device"] == "cpu" for r in rows2)
        assert all(float(r["rel_error"]) < 1e-10 for r in rows2)
        assert H.run_sweep(cfg, csv_path, echo=False) == []  # resume: nothing to add

    def test_kb_axis_complex_and_old_schema(self, tmp_path, capsys, monkeypatch):
        monkeypatch.setenv("NO_COLOR", "1")
        csv_path = str(tmp_path / "kb.csv")
        base = dict(ns=(128,), nbs=(64,), dtypes=("float32",), modes=("inplace",), repeats=2,
                    platform="cpu", timeout_s=300)
        rows = H.run_sweep(H.SweepConfig(kb=64, **base), csv_path)
        assert "\x1b[" not in capsys.readouterr().out
        assert len(rows) == 2 and all(r["exit_code"] == 0 and r["kb"] == 64 for r in rows)
        assert len(H.run_sweep(H.SweepConfig(kb=32, **base), csv_path, echo=False)) == 2
        assert H.run_sweep(H.SweepConfig(kb=64, **base), csv_path, echo=False) == []
        zrows = H.run_sweep(H.SweepConfig(**dict(base, dtypes=("complex128",),
                                                 modes=("blocked",))), csv_path, echo=False)
        assert len(zrows) == 2 and all(float(r["rel_error"]) < 1e-10 for r in zrows)
        old = str(tmp_path / "old.csv")
        with open(old, "w") as f:
            f.write(",".join(H.CSV_COLUMNS[:17]) + "\n")
        H.run_sweep(H.SweepConfig(kb=64, **base), old, echo=False)
        with open(old) as f:
            r = csv.DictReader(f)
            assert "kb" not in r.fieldnames
            got = list(r)
        assert len(got) == 2 and all(len(row) == 17 and None not in row for row in got)

    def test_a_child_that_dies_is_retried_and_recorded_once(self, tmp_path):
        csv_path = str(tmp_path / "f.csv")
        # a child that dies before any repeat line (here: a bad seed in its
        # environment) is retried, then recorded as one failed row
        cfg = H.SweepConfig(ns=(64,), nbs=(16,), dtypes=("float64",), repeats=2,
                            platform="cpu", max_retries=2, timeout_s=300)
        rows = H.run_sweep(cfg, csv_path, echo=False, env={"CHOLESKY_SEED": "x"})
        assert len(rows) == 1 and rows[0]["exit_code"] != 0 and rows[0]["retries"] == 1


class TestPlots:
    def test_grid_and_residuals_from_a_sweep(self, tmp_path):
        from dla_tpu_torch.bench.plots import plot_perf_grid, plot_residuals

        csv_path = str(tmp_path / "b.csv")
        rows = [dict(timestamp="t", scheduler=H.SCHEDULER, mapping="cuda-card", ncpu=0, ngpu=1,
                     N=n, NB=nb, run_idx=rep, ms=1.0, exit_code=0,
                     gflops=n * nb / 1000 + rep, rel_error=1e-15 * n, device=dev, mesh="1x1",
                     dtype="float64", mode="blocked", precision="high", kb="", retries="")
                for n in (64, 128) for nb in (16, 32) for rep in range(3)
                for dev in ("cuda", "cpu")]
        with open(csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=H.CSV_COLUMNS)
            w.writeheader()
            w.writerows(rows)
        p1 = plot_perf_grid(csv_path, str(tmp_path / "grid.png"))
        p2 = plot_residuals(csv_path, str(tmp_path / "res.png"))
        assert os.path.getsize(p1) > 1000 and os.path.getsize(p2) > 1000

    def test_serving(self, tmp_path):
        from dla_tpu_torch.bench.plots import plot_serving

        jp = tmp_path / "s.jsonl"
        jp.write_text("\n".join(json.dumps(r) for r in [
            {"path": "potrs", "n": 16384, "nrhs": 128, "ib": 512, "gflops": 1.2e4,
             "rhs_cols_per_s": 2.3e4},
            {"path": "potrs", "n": 16384, "nrhs": 128, "ib": 2048, "gflops": 7e3,
             "rhs_cols_per_s": 1.4e4},
            {"n": 16384, "nrhs": 1024, "gflops": 4.1e4, "rhs_cols_per_s": 7.6e4},
            {"path": "inverse", "n": 16384, "nrhs": 128, "ib": 1024, "gflops": 2.2e4,
             "rhs_cols_per_s": 4.2e4}]) + "\n")
        assert os.path.getsize(plot_serving([str(jp)], str(tmp_path / "sv.png"))) > 1000

    def test_main_and_h100_peaks(self, tmp_path):
        from dla_tpu_torch.bench import plots

        assert plots.PEAK_BY_PRECISION == {"default": 989e3, "high": 989e3 / 3,
                                           "highest": 67e3}
        csv_path = tmp_path / "m.csv"
        H.run_sweep(H.SweepConfig(ns=(64,), nbs=(32,), dtypes=("float64",), repeats=2,
                                  platform="cpu", timeout_s=300), str(csv_path), echo=False)
        assert plots.main([str(csv_path), "--out-dir", str(tmp_path / "out")]) == 0
        assert sorted(os.listdir(tmp_path / "out")) == ["perf_grid.png", "residuals.png"]


class TestProfiling:
    @pytest.mark.parametrize("dtype,prec,want", [
        ("bfloat16", None, 989e3), ("float32", "default", 989e3),
        ("float32", "high", 989e3 / 3), ("float32", "highest", 67e3),
        ("float64", None, 67e3), ("df64", None, 989e3 / 28)])
    def test_peaks(self, dtype, prec, want, monkeypatch):
        monkeypatch.delenv("DLA_TPU_PEAK_GFLOPS", raising=False)
        monkeypatch.delenv("DLA_TPU_MATMUL_PRECISION", raising=False)
        assert PF.device_peak_gflops(dtype, prec) == pytest.approx(want)

    def test_override(self, monkeypatch):
        monkeypatch.setenv("DLA_TPU_PEAK_GFLOPS", "1234.5")
        assert PF.device_peak_gflops("float64") == JPF.device_peak_gflops("float64") == 1234.5

    def test_roofline_as_jax(self):
        mine, ref = PF.Roofline(peak_gflops=1000.0), JPF.Roofline(peak_gflops=1000.0)
        for name, fl, s in (("potrf", 2e9, 0.5), ("gemm", 1e12, 2.0)):
            assert mine.record(name, fl, s) == PF.RooflineEntry(
                **vars(ref.record(name, fl, s)))
        assert mine.report() == ref.report()

    def test_time_fn_median_after_warmup(self):
        calls = []
        med, times = PF.time_fn(lambda x: calls.append(x) or torch.ones(2), 7, iters=5,
                                warmup=2)
        assert len(calls) == 7 and len(times) == 5 and med == sorted(times)[2]

    def test_trace_writes_a_chrome_trace(self, tmp_path):
        with PF.trace(str(tmp_path / "t")):
            torch.ones(64, 64) @ torch.ones(64, 64)
        path = tmp_path / "t" / "trace.json"
        assert path.stat().st_size > 0 and "traceEvents" in json.loads(path.read_text())


class TestOracle:
    def test_lines_as_jax(self, capsys):
        assert oracle.main(["--n", "256", "--nb", "64", "--cross-check", "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert jax_oracle.main(["--n", "256", "--nb", "64"]) == 0
        jout = capsys.readouterr().out
        res = [ln for ln in out.splitlines() if ln.startswith("||A - LL^T||")]
        assert res and res == [ln for ln in jout.splitlines() if ln.startswith("||A - LL^T||")]
        assert "PASS (gate 1e-10)" in out and "CROSS-CHECK PASS" in out

    def test_cross_check_needs_a_card_unless_cpu(self, capsys, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert oracle.main(["--n", "64", "--nb", "32", "--cross-check"]) == 2
        assert "no CUDA device" in capsys.readouterr().err
