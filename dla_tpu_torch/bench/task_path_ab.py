"""The fp64 tile-task path of two trees side by side on one GPU.

    python -m dla_tpu_torch.bench.task_path_ab --other DIR

``DIR`` is the root of another version of the repository, for example an
earlier commit unpacked with ``git archive`` into a directory that git
ignores. Each tree runs in a process of its own, with its own package and
its own kernel build (in that tree's ``build/``), in turns: other, this,
this, other. Each process

- factors ``plgsy(4096, seed=7)`` in fp64 by the reference's task DAG at
  NB=256 (``chip_smoke.py`` phase 25's fp64 case), one launch of
  ``potrf_tile``/``trsm_tile``/``syrk_tile``/``gemm_tile`` per task (phase
  25's loop, restated here so that both trees run the same Python): a
  warm-up, then 5 timed factorizations (host clock, synchronized), the task
  kernels' launches per block body in one factorization, a digest of the
  factor's bits and its residual;
- times one ``trsm_tile``, one ``syrk_tile`` and one ``gemm_tile`` call at
  the DAG's tile (256 × 256, fp64): the host's time to return from a call
  (200 calls queued behind a sleeping kernel, host clock) and the card's
  time of a call alone (CUDA events around the same 200 calls);
- where the tree has ``tiles.tile_op_reference`` (the scalar body's test-only
  entry), the same for the DAG with TRSM and GEMM through it, and SYRK too
  where that entry takes it.

Prints one line per process, then the median factorization time of each
tree, their ratio, and whether every process gave the factor the same bits,
with the card's name and power limit. The exit code is 1 where the bits
differ or a residual misses 1e-10. Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve()
THIS_ROOT = HERE.parents[2]
MARK = "task_path_ab: "
N, NB, REPS = 4096, 256, 5


def _dag(a, nb, potrf_tile, trsm_tile, syrk_tile, gemm_tile):
    """The task DAG of ``chip_smoke.py``'s ``tile_task_potrf`` on n/nb × n/nb
    square tiles (views of ``a``); the factor in a new matrix."""
    import torch

    nt = a.shape[0] // nb

    def view(m, i, j):
        return m[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb]

    t = {(i, j): view(a, i, j) for i in range(nt) for j in range(i + 1)}
    out = torch.zeros_like(a)
    for k in range(nt):
        lkk, linv = potrf_tile(t.pop((k, k)))
        view(out, k, k).copy_(lkk)
        for i in range(k + 1, nt):
            t[i, k] = trsm_tile(linv, t[i, k])
        for i in range(k + 1, nt):
            t[i, i] = syrk_tile(t[i, i], t[i, k])
        for i in range(k + 1, nt):
            for j in range(k + 1, i):
                t[i, j] = gemm_tile(t[i, j], t[i, k], t[j, k])
        for i in range(k + 1, nt):
            view(out, i, k).copy_(t.pop((i, k)))
    return out


def _per_call(fn, calls: int = 200) -> tuple[float, float]:
    """(host µs to return from one call, card µs of one call alone): ``calls``
    calls queued behind a sleeping kernel."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # ≈ 50 ms: longer than the host takes to queue the calls
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    h0 = time.perf_counter()
    for _ in range(calls):
        fn()
    h1 = time.perf_counter()
    e1.record()
    e1.synchronize()
    return (h1 - h0) / calls * 1e6, e0.elapsed_time(e1) / calls * 1e3


def _worker() -> dict:
    """One tree's measurements; run with that tree's root first on sys.path."""
    import hashlib
    import time

    import torch

    import dla_tpu_torch as T
    from dla_tpu_torch.kernels import _build, tiles

    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    a = T.plgsy(N, seed=7, dtype=torch.float64, device=dev)
    ops = {"library": (tiles.trsm_tile, tiles.syrk_tile, tiles.gemm_tile)}
    if hasattr(tiles, "tile_op_reference"):
        syrk_ref = "syrk" in getattr(tiles, "_OP_CODE", {})  # the entry takes syrk
        ops["scalar reference"] = (
            lambda linv, b: tiles.tile_op_reference("trsm", None, b, linv),
            (lambda c, a: tiles.tile_op_reference("syrk", c, a, a)) if syrk_ref
            else tiles.syrk_tile,
            lambda c, ai, aj: tiles.tile_op_reference("gemm", c, ai, aj))
    g = torch.Generator(device=dev).manual_seed(NB)
    c, x, y = (torch.randn(NB, NB, generator=g, device=dev, dtype=torch.float64)
               for _ in range(3))
    linv = torch.tril(y)
    out = {"root": str(Path(T.__file__).resolve().parents[1]), "build_s": build_s}
    for name, (trsm_tile, syrk_tile, gemm_tile) in ops.items():
        def factor():
            return _dag(a, NB, tiles.potrf_tile, trsm_tile, syrk_tile,  # noqa: B023
                        gemm_tile)  # noqa: B023

        before = tiles.tile_body_launches()
        l = factor()  # the warm-up
        torch.cuda.synchronize()
        bodies = {k: v - before[k] for k, v in tiles.tile_body_launches().items()}
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            factor()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        trsm_host, trsm_card = _per_call(lambda: trsm_tile(linv, x))  # noqa: B023
        syrk_host, syrk_card = _per_call(lambda: syrk_tile(c, x))  # noqa: B023
        gemm_host, gemm_card = _per_call(lambda: gemm_tile(c, x, y))  # noqa: B023
        out[name] = {
            "ms": times, "median_ms": statistics.median(times), "bodies": bodies,
            "digest": hashlib.sha256(l.cpu().numpy().tobytes()).hexdigest()[:16],
            "residual": float(T.residual_potrf(a, l)),
            "trsm_host_us": trsm_host, "trsm_card_us": trsm_card,
            "syrk_host_us": syrk_host, "syrk_card_us": syrk_card,
            "gemm_host_us": gemm_host, "gemm_card_us": gemm_card}
        del l
    return out


def _run(root: Path) -> dict:
    code = (f"import runpy, json; g = runpy.run_path({str(HERE)!r}); "
            f"print({MARK!r} + json.dumps(g['_worker']()))")
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                          text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"task_path_ab: the process in {root} failed ({proc.returncode})")
    line = next(s for s in reversed(proc.stdout.splitlines()) if s.startswith(MARK))
    return json.loads(line[len(MARK):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the other tree")
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    roots = {"other": Path(args.other).resolve(), "this": THIS_ROOT}
    runs = {"other": [], "this": []}
    for version in ("other", "this", "this", "other"):
        r = _run(roots[version])
        runs[version].append(r)
        for name in ("library", "scalar reference"):
            if name not in r:
                continue
            m = r[name]
            print(f"{version} ({r['root']}), {name}: N={N} NB={NB} fp64 "
                  f"{[round(t, 3) for t in m['ms']]} ms, median {m['median_ms']:.3f}; bodies "
                  f"{m['bodies']}; factor {m['digest']}, residual {m['residual']:.3e}; one call "
                  f"at {NB}^3: trsm_tile host {m['trsm_host_us']:.2f} us, card "
                  f"{m['trsm_card_us']:.2f} us; syrk_tile host {m['syrk_host_us']:.2f} us, card "
                  f"{m['syrk_card_us']:.2f} us; gemm_tile host {m['gemm_host_us']:.2f} us, card "
                  f"{m['gemm_card_us']:.2f} us; build {r['build_s']:.1f} s [{card}]", flush=True)
    med = {v: statistics.median(t for r in rs for t in r["library"]["ms"])
           for v, rs in runs.items()}
    every = [m for rs in runs.values() for r in rs
             for m in (r[k] for k in ("library", "scalar reference") if k in r)]
    same = len({m["digest"] for m in every}) == 1
    ok = same and all(m["residual"] < 1e-10 for m in every)
    print(f"task_path_ab: fp64 tile-task path N={N} NB={NB} through the library's "
          f"wrappers: other median {med['other']:.3f} ms, this median {med['this']:.3f} ms, "
          f"this / other {med['this'] / med['other']:.3f}; the same factor bits in every run: "
          f"{same}; every residual under 1e-10: {ok} [{card}]", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
