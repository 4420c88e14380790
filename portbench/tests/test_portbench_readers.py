"""The end-to-end readers: rates and the tail over every request."""

import types

import pytest

from portbench import spec


def _run(window, config=None, setup_s=1.0):
    return types.SimpleNamespace(window=window, config=config or {}, setup_s=setup_s)


def test_percentile_is_nearest_rank_over_all_requests():
    p = spec.metric_reader("solve_p95_ms").percentile
    xs = list(range(1, 101))
    assert p(xs, 95) == 95
    assert p(xs, 100) == 100
    assert p([7], 95) == 7
    assert p(list(range(1, 21)), 95) == 19  # ceil(0.95·20) = 19
    assert p(list(reversed(xs)), 50) == 50  # order does not matter


def test_solve_p95_reads_every_latency_in_ms():
    r = spec.metric_reader("solve_p95_ms").read(_run({"latencies_s": [0.001 * i for i in range(1, 201)]}))
    assert r == pytest.approx(190.0)
    assert spec.metric_reader("solve_p95_ms").read(_run({"latencies_s": []})) is None


def test_rates_are_all_the_work_over_the_window():
    assert spec.metric_reader("solve_rhs_per_s").read(
        _run({"widths": [64, 128, 1024], "window_s": 2.0})) == pytest.approx(608.0)
    tf = spec.metric_reader("factor_tflops").read(_run({"count": 3, "window_s": 1.5}, {"n": 30000}))
    assert tf == pytest.approx(3 * 30000**3 / 3 / 1.5 / 1e12)
    assert spec.metric_reader("setup_s").read(_run({}, setup_s=12.5)) == 12.5
