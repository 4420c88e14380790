#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dla_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero, no final line):

1. the card: name, power limit, torch and CUDA versions, the kernel build;
2. the trailing-update kernel against its plain torch version on the card,
   at the main path's shapes (m=16384, nb=tb=1024, origin 0 and 8) for the
   fp32 tiers, fp64 and bf16 storage, plus a ragged m=96, tb=32 case; upper
   tiles must come back bit-identical; kernel and plain times by CUDA events;
3. the main path: ``plgsy(16384)`` → ``potrf_inplace`` in fp32 at ``high``
   (nb=tb=kb=1024, ib=512, two-level diagonal factor), the kernel launched
   n/nb − 1 times per factorization, the residual under the driver's gate;
4. the kernel path against the plain path: N=4096 fp32 on the card against
   the same input through the plain versions on the CPU, and N=4096 fp64
   under the reference's own 1e-10 gate;
5. the driver, ``dla_tpu_torch.cli.potrf_driver``, at N=16384.

The second-to-last line is the card as ``nvidia-smi`` reports it; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or outside
the repository, the script fails before printing either.
"""

from __future__ import annotations

import contextlib
import io
import json
import statistics
import subprocess
import sys
import time

DEVICE = "cuda"
N_MAIN, NB_MAIN = 16384, 1024  # the main path: N=16384, nb=tb=kb=1024, ib=512
MAIN_KW = dict(nb=NB_MAIN, tb=NB_MAIN, kb=NB_MAIN, ib=NB_MAIN // 2, diag_factor="twolevel",
               precision="high")
N_CHECK = 4096  # kernel path against plain path


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1

    import dla_tpu_torch as T
    from dla_tpu_torch.kernels import _build, tiles
    from dla_tpu_torch.kernels.tiles import trailing_update_lower_plain
    from dla_tpu_torch.utils import precision

    dev = torch.device(DEVICE)
    card = card_line()
    tag = f"[{card}]"

    def sync():
        torch.cuda.synchronize(dev)

    # ---- 1. the card and the build ------------------------------------
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0 = {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(f"kernel build + load: {time.perf_counter() - t0:.3f} s ({_build.library_path().name}) "
          f"{tag}", flush=True)

    # ---- 2. kernel against its plain version --------------------------
    def cuda_ms(fn, iters):
        fn()
        sync()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def bits(t):
        return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])

    def kernel_case(m, tb, nb, origin, dtype, prec, iters):
        g = torch.Generator(device=dev).manual_seed(m + 7 * nb + origin)
        c = torch.randn(m, m, generator=g, device=dev, dtype=torch.float32).to(dtype)
        p = torch.randn(m - origin * tb, nb, generator=g, device=dev,
                        dtype=torch.float32).to(dtype)
        kw = dict(tb=tb, kb=nb, origin=origin)
        with precision.override(prec):
            ref = trailing_update_lower_plain(c.clone(), p, **kw)
            out = c.clone()
            before = tiles.launches
            res = tiles.trailing_update_lower(out, p, **kw)
            sync()
            require(res is out and tiles.launches == before + 1,
                    "kernel did not update c in place with one launch")
            require(not torch.equal(out, c), "alias=True left c unchanged")
            ti = torch.arange(m, device=dev) // tb
            lower = (ti[:, None] >= ti[None, :]) & (ti[:, None] >= origin) & (ti[None, :] >= origin)
            require(torch.equal(bits(torch.where(lower, 0, out)), bits(torch.where(lower, 0, c))),
                    "elements outside the lower window tiles changed")
            err = torch.where(lower, (out.double() - ref.double()).abs(), 0).max().item()
            scale = (p.double() ** 2).sum(1).max().item()  # = max |P·Pᵀ|
            if dtype == torch.float64:
                tol = 1e-12 * scale
            elif dtype == torch.float32:
                tol = 1e-5 * scale
            else:  # two bf16 roundings, each possibly one ulp apart
                tol = 2**-6 * (c.abs().max().item() + scale)
            scratch = c.clone()
            k_ms = cuda_ms(lambda: tiles.trailing_update_lower(scratch, p, **kw), iters)
            p_ms = cuda_ms(lambda: trailing_update_lower_plain(scratch, p, **kw), iters)
        name = f"m={m} tb={tb} nb={nb} origin={origin} {str(dtype)[6:]}/{prec}"
        print(f"trailing_update_lower {name}: max_abs_err={err:.3e} (tol {tol:.3e}) "
              f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms {tag}", flush=True)
        require(err <= tol, f"kernel disagrees with the plain version at {name}")
        return err, k_ms, p_ms

    main_case = None
    half = N_MAIN // NB_MAIN // 2  # origin 8: a full buffer with half its rows in the panel
    for origin in (0, half):
        for prec in ("high", "highest", "default"):
            r = kernel_case(N_MAIN, NB_MAIN, NB_MAIN, origin, torch.float32, prec, iters=5)
            if origin == 0 and prec == "high":
                main_case = r
    kernel_case(N_MAIN, NB_MAIN, NB_MAIN, 0, torch.float64, "high", iters=3)
    kernel_case(N_MAIN, NB_MAIN, NB_MAIN, 0, torch.bfloat16, "high", iters=5)
    kernel_case(96, 32, 32, 0, torch.float32, "high", iters=5)
    kernel_case(96, 32, 32, 1, torch.float32, "high", iters=5)

    # ---- 3. the main path ---------------------------------------------
    per_fact = N_MAIN // NB_MAIN - 1
    times = []
    tiles.launches = 0
    for rep in range(4):  # repeat 0 is the warm-up
        a = T.plgsy(N_MAIN, seed=51, device=dev)
        sync()
        before = tiles.launches
        t0 = time.perf_counter()
        l = T.potrf_inplace(a, **MAIN_KW)
        sync()
        dt = time.perf_counter() - t0
        require(tiles.launches - before == per_fact,
                f"{tiles.launches - before} kernel launches in one factorization, "
                f"expected {per_fact}")
        rate = N_MAIN**3 / 3 / dt / 1e9
        print(f"main path N={N_MAIN} fp32 high: repeat {rep} {dt * 1e3:.1f} ms "
              f"{rate:.2f} GFLOP/s{' (warm-up)' if rep == 0 else ''} {tag}", flush=True)
        if rep:
            times.append(dt)
    main_launches = tiles.launches
    require(main_launches == 4 * per_fact, "main path launch count")
    tmed = statistics.median(times)
    print(f"main path N={N_MAIN} fp32 high: median {tmed * 1e3:.1f} ms, "
          f"{N_MAIN**3 / 3 / tmed / 1e9:.2f} GFLOP/s, {main_launches} kernel launches {tag}",
          flush=True)
    ltri = torch.tril(l)
    require(ltri.shape == (N_MAIN, N_MAIN) and bool(torch.isfinite(ltri).all()),
            "the factor has non-finite entries")
    del a, l
    res = float(T.residual_potrf(T.plgsy(N_MAIN, seed=51, device=dev), ltri,
                                 assume_symmetric=True, assume_tril=True, row_chunk=N_MAIN // 4))
    gate = N_MAIN * 2e-7  # the driver's fp32 gate
    print(f"main path residual ||A - LL^T||_inf / ||A||_inf = {res:.3e} (gate {gate:g})",
          flush=True)
    require(res < gate, "main path residual above the fp32 gate")
    del ltri

    # ---- 4. kernel path against plain path ----------------------------
    n4 = N_CHECK
    kw4 = dict(nb=n4 // 4, tb=n4 // 16, kb=n4 // 4, ib=n4 // 8, diag_factor="twolevel",
               precision="high")
    a_cpu = T.plgsy(n4, seed=7)
    l_gpu = T.potrf_inplace(a_cpu.to(dev, copy=True), **kw4)
    l_cpu = T.potrf_inplace(a_cpu.clone(), **kw4)
    lg, lc = torch.tril(l_gpu).cpu(), torch.tril(l_cpu)
    dl = (lg - lc).abs().max().item()
    r_gpu = float(T.residual_potrf(a_cpu, lg))
    r_cpu = float(T.residual_potrf(a_cpu, lc))
    print(f"N={n4} fp32 high, kernel on the card vs plain on the CPU: max|dL|={dl:.3e} "
          f"(max|L|={lc.abs().max().item():.3e}), residuals {r_gpu:.3e} vs {r_cpu:.3e}",
          flush=True)
    require(dl <= 1e-5 * lc.abs().max().item(), "kernel-path L disagrees with the plain path")
    require(0.5 <= r_gpu / r_cpu <= 2.0, "kernel-path residual not within 2x of the plain path")
    a64 = T.plgsy(n4, seed=7, dtype=torch.float64, device=dev)
    l64 = T.potrf_inplace(a64.clone(), **kw4)
    r64 = float(T.residual_potrf(a64, l64))
    print(f"N={n4} fp64 kernel path residual {r64:.3e} (gate 1e-10)", flush=True)
    require(r64 < 1e-10, "fp64 residual above the reference's 1e-10 gate")
    del a64, l64, l_gpu

    # ---- 5. the driver ------------------------------------------------
    from dla_tpu_torch.cli import potrf_driver

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = potrf_driver.main(["--n", str(N_MAIN), "--nb", str(NB_MAIN), "--dtype", "s",
                                "--mode", "inplace", "--repeats", "2"])
    for line in buf.getvalue().splitlines():
        print(f"driver| {line}")
    print(f"driver numbers above: {tag}", flush=True)
    require(rc == 0 and "PASS" in buf.getvalue(), f"driver returned {rc} without PASS")

    err, k_ms, p_ms = main_case
    print(json.dumps({"kernels": [{
        "name": "trailing_update_lower",
        "route": "cuda",
        "source": "dla_tpu_torch/kernels/csrc/trailing_lower.cu",
        "replaces": "dla_tpu/kernels/pallas_tiles.py:328",
        "launches": main_launches,
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
