"""Sweep harness — counterpart of ``dla_tpu/bench/harness.py`` (the
reference's ``benchmark.c``), driving the port's driver.

It keeps the reference harness's semantics (``benchmark.c:69-298``) and the
JAX package's profile format, so a profile written for the JAX harness runs
unchanged:

- a config matrix N × NB × dtype × mode × mesh × repeats from a JSON profile
  (:meth:`SweepConfig.from_json`) or keyword arguments;
- one subprocess per config, ``python -m dla_tpu_torch.cli.potrf_driver``,
  with ``--repeats`` timed runs inside it (``inproc_repeats``; repeat 0 is the
  warm-up, recorded with ``run_idx=0`` as the reference's calibration
  repeat), or one subprocess per repeat;
- the driver's ``Repeat``/``Elapsed``/``Performance`` and residual (or
  Freivalds) lines are the parse contract (``benchmark.c:45-67``);
- a child that dies without printing a repeat is retried up to
  ``max_retries`` times (ArmoniK's ``max_retries``); one that printed its
  numbers and failed a gate is not; a timed-out child is recorded with exit
  code 124;
- rows are appended to the CSV the caller names as they finish, so an
  interrupted sweep resumes where it stopped (rows with the same N, NB,
  dtype, mode, mesh, precision, kb and run_idx are skipped); appending to a
  CSV with an older header keeps that header;
- ANSI colours unless ``NO_COLOR`` is set (``benchmark.c:18-21``).

The CSV has the JAX harness's columns in its order. ``scheduler`` is the
constant ``cuda-static`` (the schedule is fixed in the program; the
reference's dynamic-scheduler dimension does not exist here). A profile's
``platform: "cpu"`` becomes the driver's ``--device cpu``; any other platform
(``tpu``, ``gpu``, ``cuda`` or none) runs on the card.
"""

from __future__ import annotations

import csv
import dataclasses
import datetime
import json
import os
import re
import subprocess
import sys
import time
from typing import Iterable, Sequence

from dla_tpu_torch.utils.precision import DEFAULT as _LIB_DEFAULT

CSV_COLUMNS = [
    "timestamp",
    "scheduler",
    "mapping",
    "ncpu",
    "ngpu",
    "N",
    "NB",
    "run_idx",
    "ms",
    "exit_code",
    "gflops",
    "rel_error",
    # extensions over the reference schema:
    "device",
    "mesh",
    "dtype",
    "mode",
    "precision",
    "kb",  # trailing-update k-split ("" = the formulation's default)
    "retries",  # re-executions of a child that died without numbers ("" = none)
]

SCHEDULER = "cuda-static"

_PERF_RE = re.compile(r"Performance:\s*([0-9.eE+-]+)\s*Gflop/s")
_REPEAT_RE = re.compile(r"Repeat (\d+): ([0-9.eE+-]+) ms ([0-9.eE+-]+) Gflop/s")
_RES_RE = re.compile(r"\|\|A - LL\^T\|\|_inf / \|\|A\|\|_inf\s*=\s*([0-9.eE+-]+)")
# the matrix-free gate's value fills rel_error where the exact line is absent
_FREIVALDS_RE = re.compile(
    r"freivalds \|\|\(A - LL\^T\)x\|\| / \(\|\|A\|\| \|\|x\|\|\)\s*=\s*([0-9.eE+-]+)"
)
_ELAPSED_RE = re.compile(r"Elapsed:\s*([0-9.eE+-]+)\s*ms")
# the directory that holds the dla_tpu_torch package, for the children's imports
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _color(code: str, s: str) -> str:
    if os.environ.get("NO_COLOR"):
        return s
    return f"\x1b[{code}m{s}\x1b[0m"


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """One sweep campaign (the JSON-profile replacement for the compiled-in
    tables at ``benchmark.c:76-101``); the JAX harness's fields."""

    ns: Sequence[int] = (1024, 4096, 8192)
    nbs: Sequence[int] = (128, 256, 512)
    dtypes: Sequence[str] = ("float32",)
    modes: Sequence[str] = ("blocked",)
    meshes: Sequence[tuple[int, int]] = ((1, 1),)
    repeats: int = 8  # repeat 0 = the warm-up (calibration analogue)
    platform: str | None = None  # "cpu" → --device cpu; anything else: the card
    gen: str = "plgsy"
    panel: str = "xla"
    trailing: str = "xla"
    timeout_s: float = 900.0
    max_retries: int = 3  # per-run retry budget (client_distrib.cpp:335-337)
    precision: str | None = None  # matmul tier (None = library default)
    kb: int | None = None  # trailing k-split (shrink/inplace/packed; None = default)
    diag: str = "lax"  # diagonal-block factor
    inproc_repeats: bool = True  # one child per config, --repeats inside it

    @classmethod
    def from_json(cls, path: str) -> "SweepConfig":
        with open(path) as f:
            d = json.load(f)
        if "meshes" in d:
            d["meshes"] = [tuple(m) for m in d["meshes"]]
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @property
    def on_cpu(self) -> bool:
        return self.platform == "cpu"


def parse_metrics(stdout: str) -> tuple[float | None, float | None, float | None]:
    """Extract (gflops, rel_error, elapsed_ms) from the driver's stdout."""
    perf = _PERF_RE.search(stdout)
    res = _RES_RE.search(stdout) or _FREIVALDS_RE.search(stdout)
    ms = _ELAPSED_RE.search(stdout)
    return (
        float(perf.group(1)) if perf else None,
        float(res.group(1)) if res else None,
        float(ms.group(1)) if ms else None,
    )


def parse_repeats(stdout: str) -> list[tuple[int, float, float]]:
    """Extract (run_idx, ms, gflops) per in-process repeat line."""
    return [
        (int(m.group(1)), float(m.group(2)), float(m.group(3)))
        for m in _REPEAT_RE.finditer(stdout)
    ]


def _driver_cmd(cfg: SweepConfig, n, nb, dtype, mode, mesh, repeats=1) -> list[str]:
    cmd = [sys.executable, "-m", "dla_tpu_torch.cli.potrf_driver", "--n", str(n), "--nb",
           str(nb), "--dtype", dtype, "--mode", mode, "--gen", cfg.gen]
    if mode in ("blocked", "shrink"):
        cmd += ["--panel", cfg.panel, "--trailing", cfg.trailing]
    if mode in ("packed", "df64") and cfg.trailing != "xla":
        cmd += ["--trailing", cfg.trailing]
    if mode in ("blocked", "shrink", "inplace", "packed"):
        cmd += ["--diag", cfg.diag]
        if cfg.precision:
            cmd += ["--precision", cfg.precision]
    if cfg.kb and mode in ("shrink", "inplace", "packed"):
        cmd += ["--kb", str(cfg.kb)]
    if mode == "distributed":
        cmd += ["--p", str(mesh[0]), "--q", str(mesh[1])]
    if cfg.on_cpu:
        cmd += ["--device", "cpu"]
    if repeats > 1:
        cmd += ["--repeats", str(repeats)]
    return cmd


def _child_env(env: dict | None) -> dict:
    run_env = dict(os.environ)
    run_env["PYTHONPATH"] = _ROOT + os.pathsep + run_env.get("PYTHONPATH", "")
    if env:
        run_env.update(env)
    return run_env


def _run_child(cfg: SweepConfig, cmd: list[str], env: dict | None):
    """Run one child with the retry policy; (exit code, stdout, stderr,
    retries)."""
    exit_code, out, err, retries = 1, "", "", 0
    for attempt in range(max(1, cfg.max_retries)):
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=cfg.timeout_s, env=_child_env(env))
            exit_code, out, err = proc.returncode, proc.stdout, proc.stderr or ""
        except subprocess.TimeoutExpired as e:
            exit_code = 124
            out = e.stdout.decode() if isinstance(e.stdout, bytes) else (e.stdout or "")
            err = e.stderr.decode() if isinstance(e.stderr, bytes) else (e.stderr or "")
            break  # a timeout is not transient: record it and move on
        if exit_code == 0:
            break
        # a child that printed repeats failed a gate (deterministic); one that
        # died before any repeat may have been transient
        if parse_repeats(out) or attempt + 1 >= max(1, cfg.max_retries):
            break
        backoff = 0.0 if cfg.on_cpu else 5.0 * (attempt + 1)
        print(f"  [retry] child rc={exit_code} with no metrics — attempt {attempt + 2}/"
              f"{cfg.max_retries} in {backoff:.0f}s", file=sys.stderr, flush=True)
        time.sleep(backoff)
        retries += 1
    if exit_code != 0:
        for ln in [ln for ln in err.strip().splitlines() if ln.strip()][-4:]:
            print(f"  [child stderr] {ln[:300]}", file=sys.stderr, flush=True)
    return exit_code, out, err, retries


def run_sweep(
    cfg: SweepConfig,
    csv_path: str,
    *,
    env: dict | None = None,
    echo: bool = True,
) -> list[dict]:
    """Run the sweep, appending one CSV row per (config, repeat) to
    ``csv_path``; returns the new rows. Resumable: rows already in the CSV
    are skipped."""
    os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
    done: set[tuple] = set()
    header: list[str] | None = None
    if os.path.exists(csv_path):
        with open(csv_path) as f:
            reader = csv.DictReader(f)
            header = reader.fieldnames and list(reader.fieldnames)
            for row in reader:
                done.add((int(row["N"]), int(row["NB"]), row.get("dtype", ""),
                          row.get("mode", ""), row.get("mesh", ""),
                          row.get("precision", _LIB_DEFAULT) or _LIB_DEFAULT,
                          row.get("kb", "") or "", int(row["run_idx"])))
    new_file = not os.path.exists(csv_path) or os.path.getsize(csv_path) == 0
    rows: list[dict] = []
    with open(csv_path, "a", newline="") as f:
        # an older header keeps its columns; a fresh file gets the current ones
        writer = csv.DictWriter(f, fieldnames=header or CSV_COLUMNS, extrasaction="ignore")
        if new_file:
            writer.writeheader()
            f.flush()
        for dtype in cfg.dtypes:
            for mode in cfg.modes:
                for mesh in cfg.meshes if mode == "distributed" else [(1, 1)]:
                    for n in cfg.ns:
                        for nb in cfg.nbs:
                            if n % nb:
                                continue
                            if mode == "distributed" and (
                                    (n // nb) % mesh[0] or (n // nb) % mesh[1]):
                                continue
                            key0 = (n, nb, dtype, mode, f"{mesh[0]}x{mesh[1]}",
                                    cfg.precision or _LIB_DEFAULT,
                                    str(cfg.kb) if cfg.kb else "")
                            if cfg.inproc_repeats and cfg.repeats > 1:
                                if key0 + (0,) in done:
                                    continue
                                new = _run_config_inproc(cfg, n, nb, dtype, mode, mesh, env)
                            else:
                                new = [_run_one(cfg, n, nb, dtype, mode, mesh, rep, env)
                                       for rep in range(cfg.repeats)
                                       if key0 + (rep,) not in done]
                            for row in new:
                                writer.writerow(row)
                                f.flush()
                                rows.append(row)
                                if echo:
                                    ok = row["exit_code"] == 0
                                    tag = (_color("32", "ok") if ok
                                           else _color("31", f"rc={row['exit_code']}"))
                                    print(f"[sweep] N={n} NB={nb} {dtype} {mode} "
                                          f"mesh={mesh[0]}x{mesh[1]} rep={row['run_idx']}: "
                                          f"{row['gflops']} GF/s res={row['rel_error']} {tag}",
                                          flush=True)
    return rows


def _base_row(cfg, n, nb, dtype, mode, mesh, rep) -> dict:
    return {
        "timestamp": datetime.datetime.now().isoformat(timespec="seconds"),
        "scheduler": SCHEDULER,
        "mapping": "cpu-sim" if cfg.on_cpu else "cuda-card",
        "ncpu": 0,
        "ngpu": 0 if cfg.on_cpu else 1,
        "N": n,
        "NB": nb,
        "run_idx": rep,
        "ms": "",
        "exit_code": 0,
        "gflops": "",
        "rel_error": "",
        "device": "cpu" if cfg.on_cpu else "cuda",
        "mesh": f"{mesh[0]}x{mesh[1]}",
        "dtype": dtype,
        "mode": mode,
        "precision": cfg.precision or _LIB_DEFAULT,
        "kb": cfg.kb if cfg.kb else "",
        "retries": "",
    }


def _run_config_inproc(cfg, n, nb, dtype, mode, mesh, env) -> list[dict]:
    """One child for the whole config; one CSV row per in-process repeat
    (run_idx 0 = the warm-up)."""
    cmd = _driver_cmd(cfg, n, nb, dtype, mode, mesh, cfg.repeats - 1)
    exit_code, out, _, retries = _run_child(cfg, cmd, env)
    _, res, _ = parse_metrics(out)
    reps = parse_repeats(out)
    if not reps:  # the child died before any repeat: one failed row
        row = _base_row(cfg, n, nb, dtype, mode, mesh, 0)
        row.update(exit_code=exit_code, retries=retries or "")
        return [row]
    rows = []
    for rep, ms, gf in reps:
        row = _base_row(cfg, n, nb, dtype, mode, mesh, rep)
        row.update(ms=ms, gflops=gf, exit_code=exit_code,
                   rel_error=res if res is not None else "", retries=retries or "")
        rows.append(row)
    return rows


def _run_one(cfg, n, nb, dtype, mode, mesh, rep, env) -> dict:
    """One child for one repeat: the row of its median (one timed run)."""
    t0 = time.perf_counter()
    exit_code, out, _, retries = _run_child(cfg, _driver_cmd(cfg, n, nb, dtype, mode, mesh),
                                            env)
    wall_ms = (time.perf_counter() - t0) * 1e3
    gf, res, ms = parse_metrics(out)
    row = _base_row(cfg, n, nb, dtype, mode, mesh, rep)
    row.update(ms=round(ms if ms is not None else wall_ms, 3), exit_code=exit_code,
               gflops=gf if gf is not None else "", rel_error=res if res is not None else "",
               retries=retries or "")
    return row


def main(argv: Iterable[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="dla-bench-sweep-torch")
    ap.add_argument("--profile", help="JSON sweep profile", default=None)
    ap.add_argument("--csv", required=True, help="the CSV to append the rows to")
    ap.add_argument("--platform", default=None, help="cpu: the driver's --device cpu")
    ap.add_argument("--repeats", type=int, default=None)
    args = ap.parse_args(list(argv) if argv is not None else None)
    cfg = SweepConfig.from_json(args.profile) if args.profile else SweepConfig()
    if args.platform:
        cfg = dataclasses.replace(cfg, platform=args.platform)
    if args.repeats:
        cfg = dataclasses.replace(cfg, repeats=args.repeats)
    rows = run_sweep(cfg, args.csv)
    return 0 if all(r["exit_code"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
