"""``correct`` comes out true for sound runs and false for the control and
for each fault the cell can have: the harness's look for a chip skipped, the
rest of a run driven on the CPU at a small size with the timed path broken
underneath: a factor or solve that returns its input unchanged, one element
of an answer altered where it is produced, half of the right-hand sides
left out."""

import pytest
import torch

import dla_tpu_torch.algos as TA
from portbench import bench, program
from portbench.tests.conftest import small_cell

FACTOR = ["spotrf_high_n61440.factor", "dpotrf_fp64_n24576.factor"]
SEED = 2**31 + 77


def _run(name, control=False, seconds=0.05):
    return bench.execute(small_cell(name), SEED, seconds, False, device="cpu", control=control)


@pytest.mark.parametrize("name", FACTOR + ["dpotrf_fp64_n24576.solve"])
def test_a_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name", FACTOR + ["dpotrf_fp64_n24576.solve"])
def test_the_control_is_not_correct(name):
    r = _run(name, control=True)
    assert not r["correct"] and r["failed"] >= 1


def _unchanged(x, *a, **k):
    return x


def _altered(factor):
    def run(x, *a, **k):
        out = factor(x, *a, **k)
        out[-1, 0] += 1e-3 * out[-1, 0].abs() + 1e-6  # one element of the last tile row
        return out
    return run


@pytest.mark.parametrize("name", FACTOR)
@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_a_broken_dense_factor_is_not_correct(monkeypatch, name, fault):
    fake = _unchanged if fault == "unchanged" else _altered(TA.potrf_inplace)
    monkeypatch.setattr(TA, "potrf_inplace", fake)
    assert not _run(name)["correct"]


def _half(potrs):
    def run(l, b, *a, **k):  # half of the right-hand sides left out
        x = potrs(l, b, *a, **k)
        x[:, x.shape[1] // 2 :] = 0
        return x
    return run


def _wrong(potrs):
    def run(l, b, *a, **k):
        x = potrs(l, b, *a, **k)
        x[0, 0] += 1e-6 * x.abs().max()
        return x
    return run


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_solve_is_not_correct(monkeypatch, fault):
    fake = {"unchanged": lambda l, b, *a, **k: b.clone(), "half": _half(TA.potrs),
            "altered": _wrong(TA.potrs)}[fault]
    monkeypatch.setattr(TA, "potrs", fake)
    r = _run("dpotrf_fp64_n24576.solve")
    assert not r["correct"] and r["failed"] >= 1


def test_no_two_queries_share_their_right_hand_sides():
    cell = small_cell("dpotrf_fp64_n24576.solve")
    sut = program.entry("potrs").system(cell.config, cell.traffic, SEED, "cpu", False)
    (b1, _), (b2, _) = sut.submit(4), sut.submit(4)
    assert b1.shape == b2.shape == (cell.config["n"], 4) and not torch.equal(b1, b2)
