"""The loader finds every file by name, and BENCHMARK.json keeps to the
benchmark's contract."""

import json
import re

import pytest

from portbench import inputs, program, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_every_cell_loads_its_config_traffic_and_metrics(bench):
    for w in bench["workloads"]:
        cell = spec.cell(bench, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["loop"] in ("back_to_back", "closed")
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e  # a cell reporting a layer metric reports what it moves


def test_every_cell_finds_its_entry_by_name(bench):
    for w in bench["workloads"]:
        cell = spec.cell(bench, w["name"])
        mod = program.entry(program.entry_name(cell.config, cell.traffic))
        assert callable(mod.system) and callable(mod.numbers)
        assert callable(program.entry(cell.config["entry"]).factorize)
    with pytest.raises(ModuleNotFoundError):
        program.entry("no_such_entry")


def test_every_seed_sends_the_same_widths_in_its_own_order():
    t = spec.traffic("solve")
    a, b = inputs.query_order(t, 1), inputs.query_order(t, 2**31 + 9)
    assert sorted(a) == sorted(b) and a != b
    assert len(a) == len(t["nrhs"]) * t["per_pass"]
    assert inputs.query_order(t, 1) == a


def test_every_metric_has_a_reader_and_every_layer_its_patterns(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)
    for layer in ("trailing", "panel", "host_enqueue"):
        assert spec.layer_patterns(layer)
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_metric")
    with pytest.raises(FileNotFoundError):
        spec.layer_patterns("no_such_layer")
    with pytest.raises(ValueError):
        spec.cell(bench, "no_such_cell")


def test_the_contract_of_benchmark_json(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"] and bench["command"][1] == "portbench/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in bench[k]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/configs/") and c["reduced"] == []
        assert spec.load_json(spec.ROOT / c["file"])["source"] == c["source"]
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= 1
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    setup = next(m for m in bench["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup and setup["bound"] <= 0.25
