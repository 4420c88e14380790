"""Find what ``BENCHMARK.json`` names, by name: a cell's configuration and
traffic mix, the metrics it reports, each per-layer metric's reader and each
layer's kernel-name patterns."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of ``workloads``, with everything it names loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple
    per_layer: tuple


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _by_name(entries, name: str, what: str) -> dict:
    found = [e for e in entries if e["name"] == name]
    if not found:
        raise ValueError(f"no {what} named {name!r}; have {[e['name'] for e in entries]}")
    return found[0]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def traffic(name: str, here: Path = HERE) -> dict:
    """The traffic mix ``traffic/<name>.json``."""
    return load_json(here / "traffic" / f"{name}.json")


def cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench``: its configuration file, its traffic
    mix and the metrics it reports (those without ``workloads``, and those
    whose ``workloads`` name it)."""
    w = _by_name(bench["workloads"], name, "workload")
    entry = _by_name(bench["configs"], w["config"], "configuration")
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=load_json(root / entry["file"]),
        traffic=traffic(w["traffic"], root / "portbench"),
        end_to_end=tuple(m for m in bench["end_to_end"] if _reports(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _reports(m, name)),
    )


def metric_reader(name: str, here: Path = HERE):
    """The reader module ``metrics/<name>.py`` (names hold dots, so it is
    loaded from its file): ``read(traced)`` gives the metric or None."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def layer_patterns(layer: str, here: Path = HERE) -> tuple:
    """The compiled patterns of every ``layers/<layer>/*.txt``: one regular
    expression a line, searched in a kernel's (or a host call's) name; blank
    lines and lines starting with ``#`` are skipped."""
    files = sorted((here / "layers" / layer).glob("*.txt"))
    if not files:
        raise FileNotFoundError(f"no pattern files for layer {layer!r}")
    pats = []
    for f in files:
        for line in f.read_text().splitlines():
            line = line.strip()
            if line and not line.startswith("#"):
                pats.append(re.compile(line))
    return tuple(pats)
