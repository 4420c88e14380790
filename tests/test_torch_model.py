"""dla_tpu_torch's projection model (``parallel/model.py``, ``serving.py``)
held against dla_tpu's, and its H100 table.

The arithmetic is a copy: with the JAX package's chip table, curves, serving
rates, base chip and packed fill installed into the port's modules
(``monkeypatch``), and its calibration dataclasses' values passed as the
port's, every projection equals JAX's at rel=1e-12 (the same expressions in
the same order; an ulp apart would already fail the artifacts JAX rounds).
Without JAX's figures, the port's own table is checked: each measured knot
comes back exactly, the ceilings rank by tier, the card's memory is an 80 GB
card's, and no TPU figure appears anywhere in the port. Then the CLI of
``bench/projections.py`` against the model, and ``bench/calibrate_model.py``
refusing to run without a card.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

import dla_tpu.kernels.collectives as JC
import dla_tpu.parallel.model as JM
import dla_tpu.parallel.serving as JS
import dla_tpu_torch.kernels.collectives as TC
import dla_tpu_torch.parallel as TP
import dla_tpu_torch.parallel.model as TM
import dla_tpu_torch.parallel.serving as TS
from dla_tpu.parallel.block_cyclic import BlockCyclicLayout as JLayout
from dla_tpu_torch.bench import projections
from dla_tpu_torch.parallel.block_cyclic import BlockCyclicLayout as TLayout
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = Path(__file__).resolve().parents[1]
REL = 1e-12


def same(a, b, path="") -> None:
    """Equal structures; floats within REL of each other."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, a.keys() ^ b.keys())
        for k in a:
            same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(b, bool):
        assert b == pytest.approx(a, rel=REL, abs=0.0) or (math.isinf(a) and a == b), (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.fixture
def jax_figures(monkeypatch):
    """The JAX package's figures in the port's modules."""
    chips = {name: TM.ChipSpec(**dataclasses.asdict(spec)) for name, spec in JM.CHIPS.items()}
    monkeypatch.setattr(TM, "CHIPS", chips)
    monkeypatch.setattr(TM, "BASE_CHIP", "v5e")
    for name in ("SINGLE_CHIP_HIGH_GFLOPS", "SINGLE_CHIP_DEFAULT_GFLOPS",
                 "SINGLE_CHIP_BF16_GFLOPS", "SINGLE_CHIP_DF64_GFLOPS", "SINGLE_CHIP_CURVES"):
        monkeypatch.setattr(TM, name, getattr(JM, name))
    monkeypatch.setattr(TM, "PACKED_FILL", 0.85)  # JAX's default fill and its fits test
    monkeypatch.setattr(TS, "SERVING_RATE_GFLOPS", JS.SERVING_RATE_GFLOPS)


def _between(curve):
    pts = sorted(curve)
    return ([pts[0] // 2, pts[0], pts[-1], pts[-1] + 8192, 10**6]
            + [(a + b) // 2 for a, b in zip(pts, pts[1:])] + [a + 1 for a in pts])


class TestParityWithJax:
    @pytest.mark.parametrize("tier", ["high", "default", "bf16", "f64x", "highest"])
    @pytest.mark.parametrize("chip", ["v5e", "v5p"])
    def test_single_chip_rate(self, jax_figures, chip, tier):
        curve = JM.SINGLE_CHIP_CURVES.get(tier, (JM.SINGLE_CHIP_HIGH_GFLOPS,))[0]
        for n in _between(curve):
            same(JM.single_chip_rate(n, chip, tier), TM.single_chip_rate(n, chip, tier))

    @pytest.mark.parametrize("n,nb,p,q,tier,itemsize", [
        (8192, 512, 2, 2, "high", 4), (16384, 1024, 2, 4, "default", 4),
        (24576, 2048, 4, 2, "bf16", 2), (32768, 2048, 4, 4, "highest", 4),
        (12288, 512, 1, 3, "f64x", 8)])
    @pytest.mark.parametrize("chip", ["v5e", "v5p"])
    def test_project(self, jax_figures, n, nb, p, q, tier, itemsize, chip):
        same(JM.project(JLayout(n=n, nb=nb, p=p, q=q), chip=chip, tier=tier, itemsize=itemsize),
             TM.project(TLayout(n=n, nb=nb, p=p, q=q), chip=chip, tier=tier, itemsize=itemsize))

    @pytest.mark.parametrize("p,q,nb,tier", [(2, 2, 2048, "high"), (2, 4, 1024, "default"),
                                             (4, 4, 1024, "highest")])
    def test_crossover_n(self, jax_figures, p, q, nb, tier):
        kw = dict(chip="v5e", tier=tier, nb=nb, n_max=49152)
        same(JM.crossover_n(p, q, **kw), TM.crossover_n(p, q, **kw))

    @pytest.mark.parametrize("n,panel", [(163840, 4096), (65536, 2048), (50000, 4096)])
    def test_oocore_host_and_combo(self, n, panel):
        # the port's host law adds a per-panel term; at 0 it is JAX's law
        host = TM.OocoreHostCalib(**dataclasses.asdict(JM.OocoreHostCalib()), panel_fixed_s=0.0)
        combo = TM.OocoreComboCalib(**dataclasses.asdict(JM.OocoreComboCalib()))
        same(JM.project_oocore_host(n, panel), TM.project_oocore_host(n, panel, calib=host))
        same(JM.project_oocore_combo(n, panel), TM.project_oocore_combo(n, panel, calib=combo))
        same(JM.oocore_volumes(n, panel, 8), TM.oocore_volumes(n, panel, 8))

    @pytest.mark.parametrize("n,panel,p,q,bw", [(262144, 4096, 2, 4, 32.0),
                                                (131072, 8192, 2, 2, 100.0),
                                                (98304, 4096, 1, 1, 16.0)])
    def test_oocore_mesh(self, jax_figures, n, panel, p, q, bw):
        kw = dict(chip="v5e", tier="high", host_bw_gbps=bw, compute_eff=0.85)
        same(JM.project_oocore_mesh(n, panel, p, q, **kw),
             TM.project_oocore_mesh(n, panel, p, q, **kw))

    @pytest.mark.parametrize("ndev,itemsize", [(1, 4), (2, 4), (4, 2), (8, 8)])
    def test_packed_mesh_max_n(self, jax_figures, ndev, itemsize):
        same(JM.packed_mesh_max_n(ndev, chip="v5e", itemsize=itemsize),
             TM.packed_mesh_max_n(ndev, chip="v5e", itemsize=itemsize))
        same(JM.packed_mesh_max_n(ndev, chip="v5p", nb=2048, fill=0.7),
             TM.packed_mesh_max_n(ndev, chip="v5p", nb=2048, fill=0.7))

    @pytest.mark.parametrize("n,nb,ndev,tier,planes", [
        (65536, 4096, 4, "default", 1), (32768, 1024, 8, "bf16", 1),
        (65536, 4096, 8, "f64x", 2), (16384, 2048, 2, "high", 2), (4096, 1024, 1, "default", 1)])
    def test_project_packed_cyclic(self, jax_figures, n, nb, ndev, tier, planes):
        kw = dict(chip="v5e", tier=tier, planes=planes)
        same(JM.project_packed_cyclic(n, nb, ndev, **kw),
             TM.project_packed_cyclic(n, nb, ndev, **kw))

    @pytest.mark.parametrize("ndev,tier,itemsize,planes", [(2, "default", 4, 1), (4, "bf16", 2, 1),
                                                           (4, "f64x", 4, 2)])
    def test_packed_crossover(self, jax_figures, ndev, tier, itemsize, planes):
        kw = dict(chip="v5e", tier=tier, itemsize=itemsize, planes=planes)
        same(JM.packed_crossover(ndev, **kw), TM.packed_crossover(ndev, **kw))

    @pytest.mark.parametrize("chip", ["v5e", "v5p"])
    def test_serving(self, jax_figures, chip):
        for nrhs in (1, 2, 64, 127, 128, 129, 500, 1024, 4096):
            same(JS.serving_rate(nrhs, chip), TS.serving_rate(nrhs, chip))
            for n, p in ((16384, 2), (65536, 4), (131072, 16)):
                same(JS.project_serving(n, nrhs, p, chip=chip),
                     TS.project_serving(n, nrhs, p, chip=chip))

    def test_broadcast_chunks_are_jax(self):
        """The ring law's C: the port's kernel module gives JAX's for every
        buffer the packed planes broadcast (planes·rows, rows a multiple of nb)."""
        for d in (1, 2, 3, 4, 8, 16):
            for m in [*range(0, 600, 7), 1024, 4096, 8192, 15360, 2 * 61440, 122880, 40960 * 2]:
                assert TC.broadcast_chunks(m, d) == JC.broadcast_chunks(m, d), (m, d)

    def test_step_comm_elems(self):
        for p, q in ((2, 2), (2, 4), (4, 2)):
            jl, tl = JLayout(n=8192, nb=256, p=p, q=q), TLayout(n=8192, nb=256, p=p, q=q)
            assert [JM.step_comm_elems(jl, k) for k in range(32)] == [
                TM.step_comm_elems(tl, k) for k in range(32)]


class TestH100Table:
    @pytest.mark.parametrize("tier", sorted(TM.SINGLE_CHIP_CURVES))
    def test_knots_come_back(self, tier):
        """Each measured knot, to the rounding of the interpolation's
        r0 + (r1 − r0)·1 at an interior knot (JAX's arithmetic: an ulp)."""
        curve = TM.SINGLE_CHIP_CURVES[tier][0]
        assert len(curve) >= 8 and min(curve) == 4096
        for n, rate in curve.items():
            assert TM.single_chip_rate(n, "h100", tier) == pytest.approx(rate, rel=1e-15, abs=0)

    def test_highest_scales_the_high_curve(self):
        h = TM.CHIPS["h100"].tflops
        for n in TM.SINGLE_CHIP_HIGH_GFLOPS:
            assert TM.single_chip_rate(n, "h100", "highest") == pytest.approx(
                TM.SINGLE_CHIP_HIGH_GFLOPS[n] * (h["highest"] / h["high"]), rel=1e-15, abs=0)

    def test_one_chip_ceilings_and_memory(self):
        assert set(TM.CHIPS) == {"h100"} and TM.BASE_CHIP == "h100"
        spec = TM.CHIPS["h100"]
        t = spec.tflops
        assert t["default"] > t["high"] > t["highest"] > 0
        assert 70 < spec.hbm_gib < 80
        assert spec.ici_links == 1 and spec.ici_gbps == 450.0 and spec.hbm_gbps == 3350.0
        assert 0 < TM.COMPUTE_EFF and 0 < TM.PACKED_FILL < 1 and TM.HOST_BW_GBPS > 0

    def test_serving_knots(self):
        for nrhs, rate in TS.SERVING_RATE_GFLOPS.items():
            assert TS.serving_rate(nrhs) == rate

    def test_packed_fill_reproduces_one_card(self):
        """PACKED_FILL sits between the frontier N's share of the card and the
        next N's: packed_mesh_max_n(1) returns a multiple of 4096 whose
        triangle fits and whose successor's does not."""
        m = TM.packed_mesh_max_n(1)
        budget = TM.CHIPS["h100"].hbm_gib * 2**30 * TM.PACKED_FILL
        n = m["max_n_packed"]
        assert n % 4096 == 0 and n >= 81920  # at least the packed tier's own N
        assert TM.packed_resident_bytes(n, 4096, 1) <= budget
        assert TM.packed_resident_bytes(n + 4096, 4096, 1) > budget

    # figures of the JAX package's TPU table (dla_tpu/parallel/model.py, serving.py)
    TPU_FIGURES = ("49437", "58489", "15.75", "819.0", "169.9", "22585", "52232", "2765.0",
                   "154338", "172036", "4755.0")

    @pytest.mark.parametrize("figure", TPU_FIGURES)
    def test_no_tpu_figure_in_the_port(self, figure):
        hits = [str(p.relative_to(REPO)) for p in (REPO / "dla_tpu_torch").rglob("*.py")
                if figure in p.read_text()]
        hits += ["chip_smoke.py"] if figure in (REPO / "chip_smoke.py").read_text() else []
        assert hits == []

    def test_exports(self):
        assert TP.CHIPS is TM.CHIPS and TP.project is TM.project
        assert TP.crossover_n is TM.crossover_n and TP.single_chip_rate is TM.single_chip_rate
        assert TP.project_serving is TS.project_serving


def test_projections_cli_rows_are_the_models(tmp_path):
    out = tmp_path / "rows.json"
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "dla_tpu_torch.bench.projections", "--out",
                           str(out)], cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    rows = json.loads(out.read_text())
    assert rows["chip"] == "h100" and "not measurements" in rows["comment"]
    assert [(r["mesh"], r["crossover_n"], r["n_eff50"], r["n_eff70"]) for r in rows["crossover"]] == [
        (f"{p}x{q}", c["crossover_n"], c["n_eff50"], c["n_eff70"])
        for p, q in projections.MESHES for c in [TM.crossover_n(p, q)]]
    assert rows["serving"] == [TS.project_serving(n, r, p) for n in projections.SERVING_N
                               for r in projections.SERVING_NRHS for p in projections.SERVING_P]
    assert rows["oocore_mesh"] == [TM.project_oocore_mesh(262144, 4096, p, q)
                                   for p, q in projections.OOCORE_MESHES]
    for row in rows["packed"]:
        c = TM.packed_crossover(row["ndev"], tier=row["tier"], itemsize=row["itemsize"],
                                planes=row["planes"])
        assert (row["crossover_n"], row["mesh_max_n"], row["gflops_at_mesh_max"]) == (
            c["crossover_n"], c["mesh_max_n"], c["at_mesh_max"]["dist_gflops"])
    assert len(rows["packed"]) == len(projections.PACKED) * len(projections.PACKED_NDEV)


def test_calibrate_model_refuses_without_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "dla_tpu_torch.bench.calibrate_model",
                           "--only", "ceilings"], cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 2
    assert "no CUDA device" in proc.stderr and '"part"' not in proc.stdout


@pytest.mark.parametrize("calib_cls,project,io_per_panel", [
    (TM.OocoreHostCalib, TM.project_oocore_host, True),
    (TM.OocoreComboCalib, TM.project_oocore_combo, False)])
def test_calibrate_model_fit_recovers_the_law(monkeypatch, calib_cls, project, io_per_panel):
    """Runs made by a known law (a per-panel cost on the rest, and on the pack
    and the writeback where the fit takes one) give back that law, its check
    exact."""
    from dla_tpu_torch.bench import calibrate_model as CM

    gemm, overhead = 40000.0, 0.8
    fixed = {"rest": 0.05, "pack": 0.03 * io_per_panel, "wb": 0.11 * io_per_panel}
    rate = {"pack": 7.5, "wb": 4.25}

    def run(argv, card, part):
        n = int(argv[argv.index("--n") + 1])
        v = TM.oocore_volumes(n, CM.W_OOC)
        gib, np_ = 2.0**30, v["npanels"]
        st = {"bytes_in": v["stream_bytes"], "bytes_out": v["writeback_bytes"],
              "pack_s": v["stream_bytes"] / gib / rate["pack"] + np_ * fixed["pack"],
              "writeback_s": v["writeback_bytes"] / gib / rate["wb"] + np_ * fixed["wb"]}
        st["wall_s"] = (v["flops"] / (gemm * 1e9) * overhead + np_ * fixed["rest"]
                        + st["pack_s"] + st["writeback_s"])
        gemm_s = v["flops"] / (gemm * 1e9)
        return {"n": n, "stats": st, "gemm_s": gemm_s, "gemm_gflops": gemm}

    monkeypatch.setattr(CM, "_oocore_run", run)
    calib, err = CM._law_part("test card", "test", lambda n: [], io_per_panel, calib_cls,
                              project, 0.1)
    assert abs(err) < 1e-9
    assert calib.gemm_gflops == pytest.approx(gemm, rel=1e-12)
    assert calib.overhead == pytest.approx(overhead, rel=1e-9)
    assert calib.panel_fixed_s == pytest.approx(sum(fixed.values()), rel=1e-9)
    assert calib.pack_gibps == pytest.approx(rate["pack"], rel=1e-9)
    assert calib.writeback_gibps == pytest.approx(rate["wb"], rel=1e-9)


@pytest.mark.parametrize("gbps,lat_us", [(360.0, 2.5), (120.0, 9.0)])
def test_calibrate_model_nvlink_fit_recovers_the_ring_law(gbps, lat_us):
    """Ring broadcast times made by the model's law (C + D − 2)·(V/(C·bw) +
    lat), at the nvlink part's sizes and chunk counts, give back bw and lat."""
    from dla_tpu_torch.bench import calibrate_model as CM
    from dla_tpu_torch.kernels.collectives import broadcast_chunks

    d = 4
    points = []
    for m in CM.NVLINK_ROWS:
        v, c = m * CM.NVLINK_N * 8, broadcast_chunks(m, d)
        points.append((v, c, d, (c + d - 2) * (v / (c * gbps * 1e9) + lat_us * 1e-6)))
    bw, lat = CM.fit_ring(points)
    assert bw == pytest.approx(gbps * 1e9, rel=1e-9)
    assert lat == pytest.approx(lat_us * 1e-6, rel=1e-9)
