"""dla_tpu_torch's POTRF driver and chip_smoke.py on the CPU."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dla_tpu_torch.cli import potrf_driver
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = Path(__file__).resolve().parents[1]
FREIVALDS = r"^freivalds \|\|\(A - LL\^T\)x\|\| / \(\|\|A\|\| \|\|x\|\|\) = (\S+)$"
RESIDUAL = r"^\|\|A - LL\^T\|\|_inf / \|\|A\|\|_inf = (\S+)$"


def _run(capsys, *argv):
    rc = potrf_driver.main(list(argv))
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("dtype,extra,gate", [
    ("d", [], "1e-10"),
    ("s", ["--precision", "high", "--diag", "twolevel", "--kb", "64"], "5.12e-05"),
    ("h", ["--precision", "default"], "0.0032"),
])
def test_contract_lines_on_cpu(capsys, dtype, extra, gate):
    rc, out, _ = _run(capsys, "--n", "256", "--nb", "64", "--dtype", dtype,
                      "--device", "cpu", "--repeats", "2", *extra)
    assert rc == 0, out
    assert re.search(r"^Repeat 0: [\d.]+ ms [\d.]+ Gflop/s \(warm-up\)$", out, re.M)
    assert len(re.findall(r"^Repeat [12]: [\d.]+ ms [\d.]+ Gflop/s$", out, re.M)) == 2
    assert re.search(r"^Elapsed: [\d.]+ ms$", out, re.M)
    assert re.search(r"^Performance: \d+\.\d\d Gflop/s$", out, re.M)
    res = re.search(r"^\|\|A - LL\^T\|\|_inf / \|\|A\|\|_inf = (\S+)$", out, re.M)
    assert res and float(res.group(1)) < float(gate)
    assert f"PASS (residual < {gate})" in out


def test_env_layering_and_no_check(capsys, monkeypatch):
    monkeypatch.setenv("CHOLESKY_N", "128")
    monkeypatch.setenv("CHOLESKY_B", "32")
    rc, out, _ = _run(capsys, "--dtype", "d", "--device", "cpu", "--no-check")
    assert rc == 0
    assert "N=128 NB=32 dtype=float64 mode=inplace" in out
    assert "LL^T" not in out and "PASS" not in out
    rc, out, _ = _run(capsys, "--nb", "64", "--dtype", "d", "--device", "cpu", "--no-check")
    assert "N=128 NB=64" in out


def test_fail_gate_returns_nonzero(capsys):
    rc, out, _ = _run(capsys, "--n", "128", "--nb", "32", "--dtype", "s", "--device", "cpu",
                      "--gate", "1e-30")
    assert rc == 1 and "FAIL (residual >= 1e-30)" in out


def test_cuda_without_card_fails_clearly(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _run(capsys, "--n", "128", "--nb", "32")
    assert rc != 0 and "no CUDA device" in err and "Performance" not in out


def test_unported_dtype(capsys):
    """Complex runs on the torch routes; the default inplace mode's trailing
    kernel is real-only and raises for it (the JAX package's interpret-mode
    kernel gives a factor off by ~1e-2 instead, which its gate then fails)."""
    with pytest.raises(TypeError, match="real-only"):
        _run(capsys, "--n", "64", "--nb", "32", "--dtype", "z", "--device", "cpu")
    rc, out, _ = _run(capsys, "--n", "64", "--nb", "32", "--dtype", "z", "--mode", "blocked",
                      "--device", "cpu")
    assert rc == 0 and "dtype=complex128" in out and "PASS (residual < 1e-10)" in out


def test_chip_smoke_refuses_without_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("trailing,slices", [("xla", []), ("pallas", []), ("pallas", ["--slices", "6"])])
def test_df64_mode_on_cpu(capsys, trailing, slices):
    rc, out, _ = _run(capsys, "--mode", "df64", "--trailing", trailing, "--n", "512", "--nb", "128",
                      "--device", "cpu", *slices)
    assert rc == 0, out
    assert "N=512 NB=128 dtype=float64 mode=df64" in out  # the mode forces fp64
    assert re.search(r"^Performance: \d+\.\d\d Gflop/s$", out, re.M)
    res = re.search(r"^\|\|A - LL\^T\|\|_inf / \|\|A\|\|_inf = (\S+)$", out, re.M)
    assert res and float(res.group(1)) < 1e-10  # s=6 sits closer to the gate than s=7
    assert "PASS (residual < 1e-10)" in out


def test_df64_mode_picks_the_blocked_gate_past_the_strip_ceiling(capsys, monkeypatch):
    import dla_tpu_torch.algos as A

    calls = []
    blocked = A.residual_potrf_df64_blocked

    def spy(*args, **kw):
        calls.append(kw["rc"])
        return blocked(*args, **kw)

    monkeypatch.setattr(A, "residual_potrf_df64_blocked", spy)
    monkeypatch.setenv("DLA_TPU_DF64_STRIP_RESIDUAL_MAX", "256")
    rc, out, _ = _run(capsys, "--mode", "df64", "--n", "512", "--nb", "128", "--device", "cpu",
                      "--trailing", "pallas")
    assert rc == 0 and calls == [512] and "PASS (residual < 1e-10)" in out
    # where the blocked residual does not fit, the streaming df64 Freivalds gate runs
    monkeypatch.setattr(potrf_driver, "_memory_bytes", lambda device: 1)  # too small for it
    rc, out, err = _run(capsys, "--mode", "df64", "--n", "512", "--nb", "128", "--device", "cpu")
    assert rc == 0 and calls == [512] and "LL^T||_inf" not in out
    res = re.search(FREIVALDS, out, re.M)
    assert res and float(res.group(1)) < 1e-11 and "PASS (residual < 1e-10)" in out
    # DLA_TPU_VALIDATE_HBM_BUDGET overrides what the device holds
    monkeypatch.setenv("DLA_TPU_VALIDATE_HBM_BUDGET", str(10**12))
    rc, out, _ = _run(capsys, "--mode", "df64", "--n", "512", "--nb", "128", "--device", "cpu")
    assert rc == 0 and calls == [512, 512] and "freivalds" not in out


@pytest.mark.parametrize("mode,extra", [
    ("blocked", []),
    ("blocked", ["--panel", "pallas", "--trailing", "pallas", "--diag", "unblocked"]),
    ("masked", []),
    ("shrink", ["--panel", "blocktrsm", "--trailing", "pallas", "--precision", "highest",
                "--kb", "32"]),
    ("shrink", ["--panel", "invgemm", "--diag", "twolevel"]),
])
def test_potrf_modes_on_cpu(capsys, mode, extra):
    rc, out, _ = _run(capsys, "--mode", mode, "--n", "256", "--nb", "64", "--dtype", "s",
                      "--device", "cpu", *extra)
    assert rc == 0, out
    assert f"N=256 NB=64 dtype=float32 mode={mode}" in out
    res = re.search(r"^\|\|A - LL\^T\|\|_inf / \|\|A\|\|_inf = (\S+)$", out, re.M)
    assert res and float(res.group(1)) < 256 * 2e-7
    assert "PASS (residual < 5.12e-05)" in out


def test_shrink_mode_wires_panel_trailing_and_kb(capsys, monkeypatch):
    import dla_tpu_torch.algos as A

    calls = []
    monkeypatch.setattr(A, "potrf", lambda a, **kw: calls.append(kw) or torch.eye(a.shape[0]))
    _run(capsys, "--mode", "shrink", "--n", "64", "--nb", "32", "--device", "cpu", "--panel",
         "blocktrsm", "--trailing", "pallas", "--kb", "16", "--no-check")
    _run(capsys, "--mode", "masked", "--n", "64", "--nb", "32", "--device", "cpu", "--panel",
         "pallas", "--kb", "16", "--no-check")
    assert calls[0] == dict(nb=32, mode="shrink", uplo="L", diag_factor="lax", precision=None,
                            panel="blocktrsm", trailing="pallas", kb=16)
    assert calls[-1] == dict(nb=32, mode="masked", uplo="L")  # masked takes none of them



@pytest.mark.parametrize("extra", [[], ["--df64-split", "0"], ["--df64-split", "2"],
                                   ["--slices", "6", "--repeats", "2"]])
@pytest.mark.parametrize("budget,line", [(None, RESIDUAL), ("1", FREIVALDS)])
def test_df64_packed_mode_on_cpu(capsys, monkeypatch, extra, budget, line):
    """The generated packed path: unpacked for the dense df64 residual when that
    fits, certified straight off the packed pair (A streamed) when it does not."""
    if budget:
        monkeypatch.setenv("DLA_TPU_VALIDATE_HBM_BUDGET", budget)
    rc, out, _ = _run(capsys, "--mode", "df64-packed", "--n", "512", "--nb", "128", "--device",
                      "cpu", *extra)
    assert rc == 0, out
    assert "N=512 NB=128 dtype=float64 mode=df64-packed" in out  # the mode forces fp64
    assert re.search(r"^Repeat 0: [\d.]+ ms [\d.]+ Gflop/s \(warm-up\)$", out, re.M)
    assert re.search(r"^Performance: \d+\.\d\d Gflop/s$", out, re.M)
    res = re.search(line, out, re.M)
    assert res and float(res.group(1)) < 1e-10
    assert len(re.findall(FREIVALDS, out, re.M)) + len(re.findall(RESIDUAL, out, re.M)) == 1
    assert "PASS (residual < 1e-10)" in out


def test_df64_packed_pure_path_past_the_strip_ceiling(capsys, monkeypatch):
    """Unpacked, with A regenerated in fp32 and no lo plane: the blocked residual."""
    import dla_tpu_torch.algos as A

    calls = []
    blocked = A.residual_potrf_df64_blocked

    def spy(ah, al, *args, **kw):
        calls.append((al, kw["rc"]))
        return blocked(ah, al, *args, **kw)

    monkeypatch.setattr(A, "residual_potrf_df64_blocked", spy)
    monkeypatch.setenv("DLA_TPU_DF64_STRIP_RESIDUAL_MAX", "256")
    rc, out, _ = _run(capsys, "--mode", "df64-packed", "--n", "512", "--nb", "128", "--device",
                      "cpu")
    assert rc == 0 and calls == [(None, 512)] and re.search(RESIDUAL, out, re.M)


def test_df64_split_flag_reaches_the_split_function(capsys, monkeypatch):
    import dla_tpu_torch.algos as A

    calls = []
    split = A.potrf_packed_df64_split

    def spy(*args, **kw):
        calls.append((kw["split"], kw["ktb"], kw["s"]))
        return split(*args, **kw)

    monkeypatch.setattr(A, "potrf_packed_df64_split", spy)
    argv = ["--mode", "df64-packed", "--n", "256", "--nb", "64", "--device", "cpu", "--no-check"]
    _run(capsys, *argv)  # the default, 1, is the monolith
    assert calls == []
    _run(capsys, *argv, "--df64-split", "0")  # 0 auto-sizes: it must not fall to the monolith
    _run(capsys, *argv, "--df64-split", "3", "--slices", "6")
    assert calls == [(0, 64, 7)] * 2 + [(3, 64, 6)] * 2  # warm-up and one repeat each


@pytest.fixture
def user_matrix(tmp_path):
    import numpy as np

    g = np.random.default_rng(3).standard_normal((256, 256))
    a = g @ g.T / 256 + 4 * np.eye(256)
    a[0, 5] = 99.0  # above the diagonal: the driver reads the lower triangle only
    np.save(tmp_path / "a.npy", a)
    np.savez(tmp_path / "a.npz", other=np.zeros(3), a=a)
    a.tofile(tmp_path / "a.bin")
    return tmp_path


@pytest.mark.parametrize("mode", ["df64", "df64-packed"])
@pytest.mark.parametrize("name", ["a.npy", "a.npz", "a.bin"])
def test_df64_input_on_cpu(capsys, user_matrix, mode, name):
    rc, out, _ = _run(capsys, "--mode", mode, "--n", "256", "--nb", "64", "--device", "cpu",
                      "--trailing", "pallas", "--input", str(user_matrix / name))
    assert rc == 0, out
    res = re.search(RESIDUAL, out, re.M)  # a packed factor of a user's matrix is unpacked
    assert res and float(res.group(1)) < 1e-11 and "PASS (residual < 1e-10)" in out


def test_df64_packed_input_takes_the_dense_gates_by_budget(capsys, monkeypatch, user_matrix):
    argv = ["--mode", "df64-packed", "--n", "256", "--nb", "64", "--device", "cpu", "--input",
            str(user_matrix / "a.npy")]
    monkeypatch.setenv("DLA_TPU_DF64_STRIP_RESIDUAL_MAX", "128")
    rc, out, _ = _run(capsys, *argv)  # past the strip ceiling: the blocked residual
    assert rc == 0 and re.search(RESIDUAL, out, re.M) and "freivalds" not in out
    monkeypatch.setenv("DLA_TPU_VALIDATE_HBM_BUDGET", "1")  # nothing fits: streaming Freivalds
    rc, out, _ = _run(capsys, *argv)
    res = re.search(FREIVALDS, out, re.M)
    assert rc == 0 and res and float(res.group(1)) < 1e-11 and "LL^T||_inf" not in out


def test_input_errors(capsys, user_matrix):
    path = str(user_matrix / "a.npy")
    rc, _, err = _run(capsys, "--mode", "df64", "--n", "128", "--nb", "64", "--device", "cpu",
                      "--input", path)
    assert rc == 2 and "65536 elements, expected 128*128" in err
    # the dense modes take --input too (the df64 modes' refusal of a wrong
    # size above stays): a file of the wrong size for --n is refused, exit 2
    rc, out, _ = _run(capsys, "--mode", "inplace", "--n", "128", "--nb", "64", "--device", "cpu",
                      "--input", path)
    assert rc == 2 and "65536 elements, expected 128*128" in out


@pytest.mark.parametrize("mode,extra,dtype", [
    ("inplace", [], "s"), ("inplace", [], "h"),  # bf16 storage is driven through inplace
    ("blocked", ["--panel", "pallas", "--trailing", "pallas"], "s"),
    ("masked", [], "s"), ("shrink", ["--panel", "blocktrsm", "--trailing", "pallas"], "s"),
])
def test_dense_modes_take_the_freivalds_gate_when_the_residual_does_not_fit(
        capsys, monkeypatch, mode, extra, dtype):
    """The reference's second gate (``dla_tpu/cli/potrf_driver.py:741-766``):
    under a budget the exact residual's operands exceed, the dense modes
    validate matrix-free and print the reference's line."""
    monkeypatch.setenv("DLA_TPU_VALIDATE_HBM_BUDGET", "1")
    rc, out, _ = _run(capsys, "--n", "512", "--nb", "128", "--dtype", dtype, "--device", "cpu",
                      "--mode", mode, *extra)
    assert rc == 0, out
    res = re.search(FREIVALDS, out, re.M)
    assert res and not re.search(RESIDUAL, out, re.M)
    gate = 512 * 2e-7 if dtype == "s" else 512**0.5 * 2e-4
    assert float(res.group(1)) < gate and f"PASS (residual < {gate:g})" in out


def test_dense_mode_keeps_the_exact_residual_when_it_fits(capsys, monkeypatch):
    monkeypatch.setenv("DLA_TPU_VALIDATE_HBM_BUDGET", str(10**12))
    rc, out, _ = _run(capsys, "--n", "512", "--nb", "128", "--dtype", "s", "--device", "cpu")
    assert rc == 0 and re.search(RESIDUAL, out, re.M) and not re.search(FREIVALDS, out, re.M)
    # n with no chunk in 4096..128 dividing it: the exact residual, whatever the budget
    monkeypatch.setenv("DLA_TPU_VALIDATE_HBM_BUDGET", "1")
    rc, out, _ = _run(capsys, "--n", "96", "--nb", "32", "--dtype", "s", "--device", "cpu")
    assert rc == 0 and re.search(RESIDUAL, out, re.M)


def test_residual_bytes():
    """What must fit for the exact residual: A and tril(L), plus their whole
    fp64 copies unless the storage is fp64 or row-chunked bf16."""
    n = 1024
    assert potrf_driver._residual_bytes(n, torch.float32, 4096) == 24 * n * n
    assert potrf_driver._residual_bytes(n, torch.float64, None) == 16 * n * n
    assert potrf_driver._residual_bytes(n, torch.bfloat16, 4096) == 4 * n * n
    assert potrf_driver._residual_bytes(n, torch.bfloat16, None) == 20 * n * n
