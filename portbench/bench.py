"""One run of one cell: set up, warm up, measure the window, check the
answers against the reference, print the result.

Set-up (``setup_s``) runs from the process's start to the window's first
operation: imports, the program's kernel library (built on a checkout's
first run), the inputs made on the device, and one warm-up at every shape
the window uses (a whole factorization, or one query of each width).

Standard output: lines starting ``portbench:`` that report the cards, their
``nvidia-smi`` readings before and after the window, the sample counts and
each card's peak memory; then, last, the result's JSON line. Standard error
ends with each compared number beside its limit. With ``--trace 1`` the
metrics are the cell's per-layer ones, read from the profiled window, and a
summary of the trace is written under ``build/portbench/`` in the checkout.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import math
import sys
import time

from portbench import check, inputs, machine, program, spec, trace, window

TRACE_CYCLE_S = 2.0


@dataclasses.dataclass
class Run:
    """What a metric reader reads: the cell, the set-up time, the window's
    record and, in a traced run, the trace's summary."""

    cell: spec.Cell
    setup_s: float
    window: dict
    summary: trace.Summary | None = None

    @property
    def config(self) -> dict:
        return self.cell.config

    def patterns(self, layer: str) -> tuple:
        return _patterns(layer)


@functools.cache
def _patterns(layer: str) -> tuple:
    return spec.layer_patterns(layer)


def say(**kw) -> None:
    print("portbench: " + json.dumps(kw), flush=True)


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def _keeper(traffic: dict, seed: int, widest: int):
    """Which queries' answers the check compares: one in ``sample_every``,
    at an offset drawn from the seed, and the first query of the widest
    width."""
    every = traffic["sample_every"]
    offset = inputs.subseed(seed, "sample") % every
    first_widest = []

    def keep(seq: int, width: int) -> bool:
        if width == widest and not first_widest:
            first_widest.append(seq)
            return True
        return seq % every == offset

    return keep


def _metric(run: Run, m: dict):
    value = spec.metric_reader(m["name"]).read(run)
    return None if value is None else {"value": value, "unit": m["unit"]}


def execute(cell: spec.Cell, seed: int, seconds: float, traced: bool, *, device=None,
            control: bool = False, warm: bool = True, t_start: float | None = None) -> dict:
    """Run the cell once and return the result (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, with ``--trace``: ``breakdown``; and
    ``checks``, last). ``device`` None is the card(s); the tests give "cpu".
    ``warm`` False skips the warm-up, for readings of the check alone."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cfg, traffic = cell.config, cell.traffic
    entry = program.entry(program.entry_name(cfg, traffic))
    sut = entry.system(cfg, traffic, seed, device or "cuda:0", control)
    closed = traffic["loop"] == "closed"
    order = inputs.query_order(traffic, seed) if closed else None
    if warm and closed:
        for w in sorted(set(order)):  # every width once: its kernels and workspaces
            sut.submit(w)
    elif warm:
        sut.restage(0)
        sut.run()
    sut.sync()
    cards = [d for d in sut.devices if d.type == "cuda"]
    tracer = None
    if traced:
        tracer = trace.Tracer([d.index for d in cards] or [-1], TRACE_CYCLE_S)
        tracer.warm()
    before = machine.smi() if cards else []
    gc.collect()
    gc.freeze()  # set-up's objects out of the collector's way in the window
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s; window of {seconds} s begins")
    if closed:
        keep = _keeper(traffic, seed, max(order))
        rec = window.closed_window(sut, traffic, order, seconds, keep, tracer)
    else:
        rec = window.factor_window(sut, seconds, tracer)
    gc.unfreeze()
    after = machine.smi() if cards else []
    peaks = machine.peak_memory(cards)
    if cards:
        say(cards=[torch.cuda.get_device_name(d) for d in cards], count=len(cards))
        say(nvidia_smi_before=before, nvidia_smi_after=after)
        say(peak_memory_bytes={str(k): v for k, v in peaks.items()})
    samples = {"units": rec["count"], "window_s": rec["window_s"]}
    if closed:
        samples.update(latencies=len(rec["latencies_s"]), sent=rec["sent"],
                       compared=len(rec["kept"]))
    say(samples=samples)
    run = Run(cell, setup_s, rec, tracer.summary if tracer else None)
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        got = _metric(run, m)
        if got is not None:
            metrics[m["name"]] = got
    dev = {"platform": "gpu" if cards else "cpu",
           "kind": torch.cuda.get_device_name(cards[0]) if cards else "cpu",
           "count": len(cards) or 1, "memory_peak_bytes": max(peaks.values(), default=0)}
    result = {"attempted": rec["count"], "metrics": metrics, "device": dev}
    if tracer:
        s = tracer.summary
        dev.update(busy_s=s.busy_s(), window_s=s.window_ns / 1e9)
        result["breakdown"] = s.breakdown()
        say(trace_events=dict(s.kinds), trace_cycles=s.cycles, traced_units=s.units)
        _write_trace(cell.name, seed, s)
    # the check: the program's state freed, the reference after the window
    numbers, each = entry.numbers(sut, rec["kept"], seed)
    limits = cfg["check"]["limits"]
    correct, checks = check.judge(numbers, limits)
    (name,) = numbers  # one number a cell, over its compared answers
    failed = sum(1 for e in each.values() if not e <= limits[name])
    result = {"correct": correct, "failed": failed, **result, "checks": checks}
    del sut
    check.release(*cards)
    return result


def _write_trace(cell: str, seed: int, summary: trace.Summary) -> None:
    out = spec.ROOT / "build" / "portbench"
    out.mkdir(parents=True, exist_ok=True)
    top = sorted(summary.ops.items(), key=lambda kv: -kv[1][0])[:60]
    with open(out / f"trace-{cell}-{seed}.json", "w") as f:
        json.dump({"cell": cell, "seed": seed, "window_ns": summary.window_ns,
                   "busy_ns": summary.busy_ns, "cycles": summary.cycles,
                   "units": summary.units, "kinds": dict(summary.kinds),
                   "ops": [[d, name, ns, count] for (d, name), (ns, count) in top],
                   "calls": summary.calls.most_common(40),
                   "gaps": sorted(summary.gaps, reverse=True)}, f, indent=1)


def main(argv=None, t_start: float | None = None) -> int:
    ap = argparse.ArgumentParser(prog="portbench", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = machine.process_start() if t_start is None else t_start

    import torch

    cell = spec.cell(spec.load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        log("no CUDA device (torch.cuda.is_available() is False): no result")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"the cell asks for {cell.chips} cards, {torch.cuda.device_count()} visible: no result")
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    foreign = machine.foreign_modules()
    if foreign:
        log(f"the process holds JAX or the JAX package: {foreign}: no result")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} = {c['value']!r} (limit {c['limit']!r}): "
            f"{'within' if c['value'] <= c['limit'] else 'NOT within'}")
        c["value"] = _json_number(c["value"])
    print(json.dumps(result), flush=True)
    return 0


def _json_number(x: float):
    """``x``, or its name where JSON has no number for it (NaN, infinity)."""
    return x if math.isfinite(x) else repr(x)


if __name__ == "__main__":
    sys.exit(main())
