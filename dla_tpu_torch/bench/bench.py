"""Headline benchmark of the port: single-device tiled POTRF GFLOP/s —
counterpart of the repository's root ``bench.py``.

    python -m dla_tpu_torch.bench.bench                 # the card
    BENCH_PRECISIONS=high:inplace:64:64:256 BENCH_ITERS=1 \\
        python -m dla_tpu_torch.bench.bench --device cpu

The same tier grammar and default list as the reference
(``precision[:formulation[:nb[:kb[:n]]]]``, ``BENCH_PRECISIONS``): ``high`` on
the single-buffer ``potrf_inplace`` at N=61440, ``default`` on packed storage
at N=81920, ``highest`` on ``potrf_shrink`` at N=32768, ``bf16`` (bfloat16
storage at the default tier) on packed storage at N=106496, and ``f64x``
(emulated fp64, ``f64x[:slices[:nb[:-[:n]]]]``) at N=24576. The same
environment names: ``BENCH_N``, ``BENCH_NB``, ``BENCH_ITERS``, ``BENCH_PANEL``,
``BENCH_TRAILING``, ``BENCH_TB``, ``BENCH_KB``, ``BENCH_ALIAS``, ``BENCH_IB``,
``BENCH_DIAG``, ``BENCH_BUDGET_S``; ``BENCH_DEVICE`` (or ``--device``) names
the device, the card unless it says ``cpu``. Without a card the default run
fails; it never moves to the CPU by itself.

Per tier: generation outside the timed region (the reference times dpotrf
only, ``v6_test.c:54-57``), one warm-up, then ``BENCH_ITERS`` timed
factorizations, each of a freshly generated A + s·I, between two
``torch.cuda.synchronize()`` calls; the median, as (1/3)·N³/t
(``v6_test.c:60``). The previous factor is dropped before the next input
exists. The reference chains factorizations on the device to take a tunnel's
round trip out of its clock; there is no tunnel here, so ``gflops`` and
``gflops_raw`` are the same number.

The gate per tier, as the reference picks it: ``freivalds_device`` where the
exact residual's operands do not fit the device (its memory, or
``DLA_TPU_VALIDATE_HBM_BUDGET`` bytes), ``residual_potrf`` otherwise,
``freivalds_packed`` for packed storage, the df64 residual for ``f64x``; each
against the driver's dtype-aware threshold.

Output. One JSON line per tier on stdout **as it finishes** (a run cut short
keeps the tiers it completed), then the closing line with the reference's
keys: ``metric``, ``value``, ``unit``, ``vs_baseline`` (against the
reference's repo-best 204.8 GFLOP/s, fp64 DPOTRF on 3 CPUs + 1 GPU),
``residual``, ``gflops_raw``, ``tiers``, ``config``. A tier that the time
budget leaves out is printed as skipped. The exit code is non-zero, after the
closing line, when a tier's gate failed. Diagnostics go to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

BASELINE_GFLOPS = 204.8  # reference repo-best (BASELINE.md)
DEFAULT_TIERS = ("high:inplace:1024:1024:61440,default:packed:4096:4096:81920,"
                 "highest,bf16:packed:4096:4096:106496,f64x:7")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def parse_tier(spec: str, *, nb: int, kb: int, n: int) -> dict:
    """One tier spec, by the reference's grammar (``bench.py:613-649``):
    ``precision[:formulation[:nb[:kb[:n]]]]`` with ``-`` as a placeholder for
    kb; precision ``bf16`` selects bfloat16 storage at the default tier;
    ``f64x[:slices[:nb[:-[:n]]]]`` is the emulated-fp64 tier (slices ride the
    formulation slot). ``nb``, ``kb`` and ``n`` are the run's defaults."""
    parts = spec.strip().split(":")
    prec, storage = parts[0], "float32"
    if prec == "bf16":
        storage, prec = "bfloat16", "default"
    if prec == "f64x":
        return {"key": "f64x", "precision": "f64x", "storage": "df64",
                "slices": int(parts[1]) if len(parts) > 1 else 7,
                "nb": int(parts[2]) if len(parts) > 2 else 1024,
                "n": int(parts[4]) if len(parts) > 4 else 24576}
    form = parts[1] if len(parts) > 1 else "shrink"
    key = f"{prec}_{form}" if form != "shrink" else prec
    if storage == "bfloat16":
        key = f"bf16_{key}"
    return {"key": key, "precision": prec, "storage": storage, "formulation": form,
            "nb": int(parts[2]) if len(parts) > 2 else nb,
            "kb": int(parts[3]) if len(parts) > 3 and parts[3] != "-" else kb,
            "n": int(parts[4]) if len(parts) > 4 else n}


def _gen_dense(n: int, s: float, dtype, device):
    """The seeded SPD matrix + s·I in storage dtype ``dtype``, built in fp32
    row slabs and cast per slab, so no N² buffer wider than ``dtype`` exists.
    The per-iteration ``s`` keeps the timed repeats on distinct inputs."""
    import torch

    from dla_tpu_torch.ops import plgsy_tile

    out = torch.empty((n, n), dtype=dtype, device=device)
    chunk = 2048
    for r0 in range(0, n, chunk):
        rows = min(chunk, n - r0)
        tile = plgsy_tile(51, r0, 0, rows, n, bump=float(n), dtype=torch.float32, device=device)
        tile.diagonal(offset=r0).add_(s)
        out[r0 : r0 + rows] = tile
    return out


def _time_tier(tag: str, n: int, iters: int, gen, factor, sync) -> tuple:
    """One warm-up and ``iters`` timed factorizations, each of a fresh input
    ``gen(s)``; returns the last factor, the warm-up's seconds and the timed
    seconds."""
    a = gen(0.0)
    sync()
    t0 = time.perf_counter()
    l = factor(a)
    sync()
    warmup_s = time.perf_counter() - t0
    log(f"[{tag}] warm-up (builds and loads the kernels on first use): {warmup_s:.1f}s")
    times = []
    for i in range(iters):
        l = a = None  # drop the previous factor before the next input exists
        a = gen((i + 1) * 1e-3)
        sync()
        t0 = time.perf_counter()
        l = factor(a)
        sync()
        times.append(time.perf_counter() - t0)
        log(f"[{tag}] iter {i}: {times[-1]:.4f}s -> {(n**3 / 3) / times[-1] / 1e9:.1f} GFLOP/s")
    return l, warmup_s, times


def run_tier(t: dict, cfg: dict, device, sync) -> dict:
    """A dense tier (``bench.py:242-429``): ``potrf_inplace`` or
    ``potrf_shrink`` on fp32 or bf16 storage."""
    import torch

    from dla_tpu_torch.algos import potrf_inplace, potrf_shrink
    from dla_tpu_torch.cli.potrf_driver import _memory_bytes, _residual_bytes
    from dla_tpu_torch.validate import freivalds_device, residual_potrf

    n, nb, kb, prec = t["n"], t["nb"], t["kb"], t["precision"]
    dt = getattr(torch, t["storage"])
    diag = cfg["diag_for"](prec)

    def factor(a):
        if t["formulation"] == "inplace":
            return potrf_inplace(a, nb=nb, tb=cfg["tb"], kb=kb, diag_factor=diag,
                                 precision=prec, ib=cfg["ib"])
        return potrf_shrink(a, nb=nb, panel=cfg["panel"], trailing=cfg["trailing"],
                            tb=cfg["tb"], kb=kb, trailing_alias=cfg["alias"],
                            diag_factor=diag, precision=prec, ib=cfg["ib"])

    l, warmup_s, times = _time_tier(t["key"], n, cfg["iters"],
                                    lambda s: _gen_dense(n, s, dt, device), factor, sync)
    # the gate: the exact residual where its operands fit the device, else
    # matrix-free (A regenerated chunk by chunk from its seed). The factor is
    # of A + s·I with s = iters·1e-3 while the probe regenerates bare A; the
    # mismatch is ~s/||A||_inf ≈ 1e-8, far below the fp32 residual scale.
    rc = next(c for c in (2048, 1024, 512, 256, 128, 1) if n % c == 0)
    budget = int(os.environ.get("DLA_TPU_VALIDATE_HBM_BUDGET", _memory_bytes(device)))
    chunk_f = next((c for c in (4096, 2048, 1024, 512) if n % c == 0), None)
    if _residual_bytes(n, dt, rc) > budget and chunk_f:
        res = float(freivalds_device(l, seed=51, bump=float(n), probes=2, row_chunk=chunk_f))
        validation = "freivalds"
    else:
        l = torch.tril(l)
        a = _gen_dense(n, cfg["iters"] * 1e-3, dt, device)
        res = float(residual_potrf(a, l, assume_symmetric=True, assume_tril=True, row_chunk=rc))
        validation = "residual"
    return {"residual": res, "validation": validation, "warmup_s": warmup_s, "times": times}


def run_tier_packed(t: dict, cfg: dict, device, sync) -> dict:
    """A packed-storage tier (``bench.py:431-534``): triangle-only storage
    with the packed trailing kernel, gated by the matrix-free streamed
    Freivalds value."""
    import torch

    from dla_tpu_torch.algos import freivalds_packed, plgsy_packed, potrf_packed

    n, w, prec = t["n"], t["nb"], t["precision"]
    dt = getattr(torch, t["storage"])

    def gen(s):
        p = plgsy_packed(n, w, seed=51, dtype=dt, device=device)
        p[0, 0] += s * 1e-9
        return p

    def factor(p):
        return potrf_packed(p, n, w, precision=prec, trailing="pallas", ktb=1024,
                            kb=t["kb"] or w, diag_factor=cfg["diag_for"](prec), ib=cfg["ib"])

    l, warmup_s, times = _time_tier(t["key"], n, cfg["iters"], gen, factor, sync)
    res = float(freivalds_packed(l, n, w, seed=51, key=1))
    return {"residual": res, "validation": "freivalds", "warmup_s": warmup_s, "times": times}


def run_tier_df64(t: dict, cfg: dict, device, sync) -> dict:
    """The emulated-fp64 tier (``bench.py:536-611``): the exactly-fp32 SPD
    matrix with a zero lo plane through ``potrf_df64`` with the df64 trailing
    kernel, gated at 1e-10 by the df64 residual on the device (block-tiled
    past ``DLA_TPU_DF64_STRIP_RESIDUAL_MAX``)."""
    import torch

    from dla_tpu_torch.algos import potrf_df64, residual_potrf_df64, residual_potrf_df64_blocked
    from dla_tpu_torch.ops import plgsy

    n, nb, s = t["n"], t["nb"], t["slices"]

    def gen(_):
        h = plgsy(n, bump=float(n), seed=51, dtype=torch.float32, device=device)
        return h, torch.zeros_like(h)

    def factor(pair):
        return potrf_df64(*pair, nb=nb, s=s, trailing="pallas", tb=min(512, nb))

    (lh, ll), warmup_s, times = _time_tier(t["key"], n, cfg["iters"], gen, factor, sync)
    ah = plgsy(n, bump=float(n), seed=51, dtype=torch.float32, device=device)
    if n > int(os.environ.get("DLA_TPU_DF64_STRIP_RESIDUAL_MAX", 8192)):
        res = float(residual_potrf_df64_blocked(ah, None, lh, ll, s=s, rc=min(2048, n)))
        validation = "df64-device-blocked-residual"
    else:
        res = float(residual_potrf_df64(ah, torch.zeros_like(ah), lh, ll, s=s))
        validation = "df64-device-residual"
    return {"residual": res, "validation": validation, "warmup_s": warmup_s, "times": times}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dla-bench-torch", description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"],
                    default=os.environ.get("BENCH_DEVICE", "cuda"))
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        log("[bench] --device cuda: no CUDA device is available "
            "(torch.cuda.is_available() is False); use --device cpu")
        return 2

    from dla_tpu_torch.cli.potrf_driver import _gate
    from dla_tpu_torch.utils.precision import DEFAULT as LIB_DEFAULT_PRECISION

    env = os.environ.get
    n, nb, kb = int(env("BENCH_N", 32768)), int(env("BENCH_NB", 8192)), int(env("BENCH_KB", 256))
    diag_env = env("BENCH_DIAG", "auto")
    cfg = {
        "iters": int(env("BENCH_ITERS", 3)),
        "panel": env("BENCH_PANEL", "blocktrsm"),
        "trailing": env("BENCH_TRAILING", "pallas"),
        "tb": int(env("BENCH_TB", 1024)),
        "alias": env("BENCH_ALIAS", "0") == "1",
        "ib": int(env("BENCH_IB", 512)),
        # the reference's per-tier choice (bench.py:78-82)
        "diag_for": lambda p: (diag_env if diag_env != "auto"
                               else "lax" if p == "highest" else "twolevel"),
    }
    specs = env("BENCH_PRECISIONS", DEFAULT_TIERS).split(",")
    budget_s = float(env("BENCH_BUDGET_S", 1400))
    device = torch.device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    log(f"device={name} N={n} NB={nb} iters={cfg['iters']} panel={cfg['panel']} "
        f"trailing={cfg['trailing']} tb={cfg['tb']} kb={kb} alias={cfg['alias']} "
        f"diag={diag_env} tiers={specs}")
    t_start = time.perf_counter()
    results: dict[str, dict] = {}
    failed = []
    for spec in specs:
        t = parse_tier(spec, nb=nb, kb=kb, n=n)
        elapsed = time.perf_counter() - t_start
        if results:
            # a further tier costs about what the longest one so far did; skip it
            # if the remaining budget cannot absorb that (the headline has priority)
            est = max(r["wall_s"] for r in results.values())
            if elapsed + est > budget_s:
                log(f"[{spec}] skipped: {elapsed:.0f}s elapsed + ~{est:.0f}s est > "
                    f"{budget_s:.0f}s budget")
                print(json.dumps({"tier": t["key"], "spec": spec.strip(),
                                  "skipped": "time budget", "elapsed_s": elapsed,
                                  "budget_s": budget_s}), flush=True)
                continue
        if t["precision"] == "f64x":
            runner, gate = run_tier_df64, 1e-10
        else:
            runner = run_tier_packed if t["formulation"] == "packed" else run_tier
            gate = _gate(t["n"], t["storage"])
        r = runner(t, cfg, device, sync)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        tmed = statistics.median_high(r["times"])  # the reference's sorted(times)[len // 2]
        r["gflops"] = r["gflops_raw"] = (t["n"] ** 3 / 3) / tmed / 1e9
        r["wall_s"] = time.perf_counter() - t_start - elapsed
        r["passed"] = r["residual"] < gate  # False for NaN
        r.update(n=t["n"], nb=t["nb"])
        if t.get("kb", kb) != kb:
            r["kb"] = t["kb"]
        results[t["key"]] = r
        if not r["passed"]:
            failed.append(t["key"])
        log(f"[{t['key']}] Performance: {r['gflops']:.2f} Gflop/s; {r['validation']} "
            f"{r['residual']:.2e} (gate {gate:g}: {'PASS' if r['passed'] else 'FAIL'})")
        print(json.dumps({"tier": t["key"], "spec": spec.strip(), "device": name, "gate": gate,
                          **r}), flush=True)

    if not results:
        log("[bench] no tier ran")
        return 1
    head_tier = LIB_DEFAULT_PRECISION if LIB_DEFAULT_PRECISION in results else next(iter(results))
    head = results[head_tier]
    # same tier, fp32 storage, another formulation: the faster one is the
    # headline when its residual is in the same class (bench.py:668-676)
    alt = results.get(f"{head_tier}_inplace")
    if alt and alt["gflops"] > head["gflops"] and alt["residual"] <= 5 * head["residual"]:
        head_tier, head = f"{head_tier}_inplace", alt
    print(json.dumps({
        "metric": f"POTRF fp32({head_tier}) N={head['n']} NB={head['nb']} single-device {name}",
        "value": head["gflops"],
        "unit": "GFLOP/s",
        "vs_baseline": float(f"{head['gflops'] / BASELINE_GFLOPS:.4g}"),
        "residual": head["residual"],
        "gflops_raw": head["gflops_raw"],
        "tiers": {k: {f: r[f] for f in ("gflops", "gflops_raw", "residual", "nb", "n",
                                        "validation")} for k, r in results.items()},
        "config": {"panel": cfg["panel"], "trailing": cfg["trailing"], "tb": cfg["tb"], "kb": kb,
                   "alias": cfg["alias"], "diag_factor": diag_env, "ib": cfg["ib"]},
    }), flush=True)
    if failed:
        log(f"[bench] gate FAILED for {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
