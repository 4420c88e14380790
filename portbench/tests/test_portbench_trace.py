"""The reduction of a trace: busy time as a union, idle share, gaps named
by the host, operations by layer, from synthetic events."""

import types

import pytest

from portbench import spec, trace


def _events():
    # one device: two overlapping kernels (0-10, 5-20), a copy (30-40); a gap
    # 20-30 under a host launch (18-29), a gap 40-100 with no host call
    return [
        ("device", "void dla::tc::trailing_tc_kernel<2, float>(...)", 0, 0, 10),
        ("device", "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n", 0, 5, 20),
        ("device", "Memcpy DtoD (Device -> Device)", 0, 30, 40),
        ("host", "cudaLaunchKernel", -1, 18, 29),
        ("host", "cudaDeviceSynchronize", -1, 99, 100),
    ]


def test_busy_is_the_union_and_idle_the_rest_of_the_window():
    s = trace.Summary(devices=[0])
    trace.reduce_cycle(_events(), s)
    assert s.window_ns == 100
    assert s.busy_ns[0] == 30  # [0, 20) and [30, 40)
    assert s.idle_share() == pytest.approx(0.7)
    assert s.busy_s() == pytest.approx(30e-9)


def test_gaps_are_named_by_the_host_call_under_them():
    s = trace.Summary(devices=[0])
    trace.reduce_cycle(_events(), s)
    gaps = dict((name, ns) for ns, name in s.gaps)
    assert gaps[trace.OUTSIDE] == 60
    assert gaps["cudaLaunchKernel"] == 10
    b = s.breakdown()
    assert b["idle_gaps"][0] == [trace.OUTSIDE, 60e-9]
    assert [n for n, _ in b["device_ops"]][0].startswith("sm80_xmma_gemm")


def test_cycles_add_up_and_every_device_counts_in_the_mean():
    s = trace.Summary(devices=[0, 1])
    trace.reduce_cycle(_events(), s)
    trace.reduce_cycle([(k, n, d, a + 1000, b + 1000) for k, n, d, a, b in _events()], s)
    assert s.window_ns == 200 and s.cycles == 2
    assert s.busy_ns == {0: 60, 1: 0}
    assert s.idle_share() == pytest.approx(1 - 30 / 200)  # card 1 idle throughout


def test_layers_classify_operations_and_host_calls():
    s = trace.Summary(devices=[0])
    trace.reduce_cycle(_events() + [
        ("device", "void dla::chain::trailing_dmma_kernel<true>(...)", 0, 50, 60),
        ("device", "void kernel<getrf_wo_pivot_params_<float>>(...)", 0, 60, 61),
        ("host", "cudaLaunchKernelExC", -1, 50, 51)], s)
    assert s.op_ns(spec.layer_patterns("trailing")) == 20
    assert s.op_ns(spec.layer_patterns("panel")) == 16  # the GEMM and getrf, not the copies
    assert s.call_count(spec.layer_patterns("host_enqueue")) == 2


def test_layer_patterns_do_not_overlap_on_the_kernels_seen():
    names = ["void dla::tc::trailing_tc_kernel<2, float>", "void dla::tc::split_kernel<float, 2>",
             "void dla::chain::trailing_dmma_kernel<true>", "void dla::chain::trailing_simt_kernel",
             "sm90_xmma_gemm_f64f64", "void trsm_left_kernel<int, double>",
             "void kernel<getrf_wo_pivot_params_<double>>", "Memcpy DtoD (Device -> Device)",
             "Memcpy PtoP (Device -> Device)", "Memset (Device)", "cublasLt::splitKreduce_kernel"]
    layers = ("trailing", "panel")
    for name in names:
        hits = [ly for ly in layers if any(p.search(name) for p in spec.layer_patterns(ly))]
        assert len(hits) <= 1, (name, hits)


def test_per_layer_readers_on_a_summary():
    s = trace.Summary(devices=[0], window_ns=10**9, busy_ns={0: 9 * 10**8}, units=2,
                      widths=[64, 1024])
    s.ops[(0, "void dla::chain::trailing_dmma_kernel<true>")] = [10**8, 3]
    s.ops[(0, "void trsm_left_kernel<int, double>")] = [4 * 10**6, 5]
    s.calls["cudaLaunchKernel"] = 900
    s.calls["cudaLaunchKernelExC"] = 100
    s.calls["cudaMemcpyAsync"] = 7
    cfg = {"n": 4096, "nb": 512, "tb": 512, "dtype": "float64"}
    run = types.SimpleNamespace(summary=s, config=cfg, patterns=spec.layer_patterns)
    rd = spec.metric_reader
    assert rd("device_idle_pct.factor").read(run) == pytest.approx(10.0)
    assert rd("panel_ms.factor").read(run) == pytest.approx(2.0)
    assert rd("launches_per_query.solve").read(run) == pytest.approx(500.0)
    from portbench import roofline
    least = roofline.trailing_bound_s(4096, 512, 512, "float64", None)
    assert rd("trailing_roofline_pct.factor").read(run) == pytest.approx(100 * least * 2 / 0.1)
    sol = sum(roofline.solve_bound_s(4096, w, "float64") for w in (64, 1024))
    assert rd("solve_roofline_pct.solve").read(run) == pytest.approx(100 * sol / 0.9)
    s.ops.clear()
    assert rd("panel_ms.factor").read(run) is None  # nothing to read: no number, never 0
