#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dla_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero, no final line):

1. the card: name, power limit, torch and CUDA versions, the kernel build
   (one ``nvcc`` per source, started together);
2. the dense trailing-update kernel against its plain torch version on the
   card, at the main path's shapes (m=16384, nb=tb=1024, origin 0 and 8) for
   the fp32 tiers, fp64 and bf16 storage, plus a ragged m=96, tb=32 case;
   upper tiles must come back bit-identical; kernel and plain times by CUDA
   events;
3. the main path: ``plgsy(16384)`` → ``potrf_inplace`` in fp32 at ``high``
   (nb=tb=kb=1024, ib=512, two-level diagonal factor), the kernel launched
   n/nb − 1 times per factorization, the residual under the driver's gate;
4. the kernel path against the plain path: N=4096 fp32 on the card against
   the same input through the plain versions on the CPU, and N=4096 fp64
   under the reference's own 1e-10 gate;
5. the driver, ``dla_tpu_torch.cli.potrf_driver``, at N=16384;
6. the packed trailing-update kernel against its plain version on the card:
   N=81920, w=4096, ktb=1024 at steps k=0 and k=nt/2 for the fp32 tiers,
   bf16 storage at the same shape, fp64 at N=32768, and a ragged n=384,
   w=96, ktb=32 case; elements outside the visited tiles must come back
   bit-identical and each call must launch the kernel once;
7. the packed path at the reference's ``default:packed`` tier:
   ``plgsy_packed(81920, 4096)`` → ``potrf_packed(trailing="pallas")`` in
   fp32 at ``default`` (ktb=1024, kb=4096, ib=512, two-level diagonal
   factor), the packed kernel launched n/w − 1 = 19 times per
   factorization, the matrix-free Freivalds value under the fp32 gate;
8. the packed kernel path against the plain path: N=4096 fp32 on the card
   against the CPU, N=4096 fp64 under 1e-10, bf16 storage at N=16384;
9. the driver with ``--mode packed --trailing pallas`` at phase 7's size.

Then the ``kernels`` JSON line, the total wall time, the card as
``nvidia-smi`` reports it, and last ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside the repository, the script fails before
printing any of those.
"""

from __future__ import annotations

import contextlib
import io
import json
import statistics
import subprocess
import sys
import time

import torch

DEVICE = "cuda"
N_MAIN, NB_MAIN = 16384, 1024  # the main path: N=16384, nb=tb=kb=1024, ib=512
MAIN_KW = dict(nb=NB_MAIN, tb=NB_MAIN, kb=NB_MAIN, ib=NB_MAIN // 2, diag_factor="twolevel",
               precision="high")
N_CHECK = 4096  # kernel path against plain path
# the packed path: the reference's default:packed tier (bench.py:136-140, :431-534)
N_PACKED, W_PACKED, KTB_PACKED = 81920, 4096, 1024
PACKED_KW = dict(diag_factor="twolevel", ib=512, precision="default", trailing="pallas",
                 ktb=KTB_PACKED, kb=W_PACKED)
N_PACKED64 = 32768  # fp64 kernel case: 81920 plus a clone would not fit beside the plain one
N_PACKED_BF16 = 16384


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def sync() -> None:
    torch.cuda.synchronize()


def cuda_ms(fn, iters: int) -> float:
    """Mean time of ``fn`` on the card over ``iters`` calls, after one warm-up."""
    fn()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def tolerance(dtype, c: torch.Tensor, p: torch.Tensor) -> float:
    """fp64 1e-12·scale; fp32 1e-5·scale (the same partial products summed in
    another order); bf16 2^-6·(max|c| + scale) (two bf16 roundings, each
    possibly one ulp apart); scale = max_i ||p_i||² = max |P·Pᵀ|."""
    scale = (p.double() ** 2).sum(1).max().item()
    if dtype == torch.float64:
        return 1e-12 * scale
    if dtype == torch.float32:
        return 1e-5 * scale
    return 2**-6 * (c.abs().max().item() + scale)


# ---- 2. the dense kernel against its plain version ----------------------------
def lower_case(dev, tag, m, tb, nb, origin, dtype, prec, iters):
    from dla_tpu_torch.kernels import tiles
    from dla_tpu_torch.kernels.tiles import trailing_update_lower_plain
    from dla_tpu_torch.utils import precision

    g = torch.Generator(device=dev).manual_seed(m + 7 * nb + origin)
    c = torch.randn(m, m, generator=g, device=dev, dtype=torch.float32).to(dtype)
    p = torch.randn(m - origin * tb, nb, generator=g, device=dev, dtype=torch.float32).to(dtype)
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
        tol = tolerance(dtype, c, p)
        k_ms = cuda_ms(lambda: tiles.trailing_update_lower(out, p, **kw), iters)
        p_ms = cuda_ms(lambda: trailing_update_lower_plain(ref, p, **kw), iters)
    name = f"m={m} tb={tb} nb={nb} origin={origin} {str(dtype)[6:]}/{prec}"
    print(f"trailing_update_lower {name}: max_abs_err={err:.3e} (tol {tol:.3e}) "
          f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms {tag}", flush=True)
    require(err <= tol, f"kernel disagrees with the plain version at {name}")
    return err, k_ms, p_ms


def phase_lower_kernel(dev, tag):
    main_case = None
    half = N_MAIN // NB_MAIN // 2  # origin 8: a full buffer with half its rows in the panel
    for origin in (0, half):
        for prec in ("high", "highest", "default"):
            r = lower_case(dev, tag, N_MAIN, NB_MAIN, NB_MAIN, origin, torch.float32, prec, 5)
            if origin == 0 and prec == "high":
                main_case = r
    lower_case(dev, tag, N_MAIN, NB_MAIN, NB_MAIN, 0, torch.float64, "high", 3)
    lower_case(dev, tag, N_MAIN, NB_MAIN, NB_MAIN, 0, torch.bfloat16, "high", 5)
    lower_case(dev, tag, 96, 32, 32, 0, torch.float32, "high", 5)
    lower_case(dev, tag, 96, 32, 32, 1, torch.float32, "high", 5)
    return main_case


# ---- 3. the main path ---------------------------------------------------------
def phase_main_path(dev, tag):
    import dla_tpu_torch as T
    from dla_tpu_torch.kernels import tiles

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
    return main_launches


# ---- 4. kernel path against plain path -----------------------------------------
def phase_inplace_check(dev):
    import dla_tpu_torch as T

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


# ---- 5. and 9. the driver -------------------------------------------------------
def phase_driver(tag, argv):
    from dla_tpu_torch.cli import potrf_driver

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = potrf_driver.main(argv)
    for line in buf.getvalue().splitlines():
        print(f"driver| {line}")
    print(f"driver numbers above: {tag}", flush=True)
    require(rc == 0 and "PASS" in buf.getvalue(), f"driver returned {rc} without PASS")


# ---- 6. the packed kernel against its plain version -----------------------------
def packed_case(dev, tag, n, w, ktb, k, dtype, prec, iters):
    from dla_tpu_torch.algos.packed import _row_offset, packed_rows
    from dla_tpu_torch.kernels import tiles
    from dla_tpu_torch.kernels.tiles import trailing_update_packed_plain
    from dla_tpu_torch.utils import precision

    nt, base = n // w, (k + 1) * w
    g = torch.Generator(device=dev).manual_seed(n + 7 * k + w)
    c = torch.randn(packed_rows(n, w), w, generator=g, device=dev, dtype=torch.float32).to(dtype)
    p = torch.randn(n - base, w, generator=g, device=dev, dtype=torch.float32).to(dtype)
    kw = dict(n=n, w=w, k=k, tb=ktb, kb=w)
    with precision.override(prec):
        ref = trailing_update_packed_plain(c.clone(), p, **kw)
        out = c.clone()
        before = tiles.packed_launches
        res = tiles.trailing_update_packed(out, p, **kw)
        sync()
        require(res is out and tiles.packed_launches == before + 1,
                "packed kernel did not update the buffer in place with one launch")
        err, changed = 0.0, False
        for j in range(nt):  # slab by slab: the visited mask of one slab at a time
            rows = slice(_row_offset(j, nt, w), _row_offset(j, nt, w) + (nt - j) * w)
            r = torch.arange(j * w, n, device=dev) - base  # window coordinates
            cc = torch.arange(j * w, (j + 1) * w, device=dev) - base
            visit = ((r[:, None] >= 0) & (cc[None, :] >= 0)
                     & (r.clamp(min=0)[:, None] // ktb >= cc.clamp(min=0)[None, :] // ktb))
            o, c0 = out[rows], c[rows]
            require(torch.equal(bits(torch.where(visit, 0, o)), bits(torch.where(visit, 0, c0))),
                    f"elements outside the visited tiles of slab {j} changed")
            changed = changed or not torch.equal(o, c0)
            d = torch.where(visit, (o.double() - ref[rows].double()).abs(), 0)
            err = max(err, d.max().item())
            del visit, o, c0, d
        require(changed, "the packed kernel changed nothing")
        tol = tolerance(dtype, c, p)
        del c
        k_ms = cuda_ms(lambda: tiles.trailing_update_packed(out, p, **kw), iters)
        p_ms = cuda_ms(lambda: trailing_update_packed_plain(ref, p, **kw), iters)
    name = f"n={n} w={w} ktb={ktb} k={k} {str(dtype)[6:]}/{prec}"
    print(f"trailing_update_packed {name}: max_abs_err={err:.3e} (tol {tol:.3e}) "
          f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms {tag}", flush=True)
    require(err <= tol, f"packed kernel disagrees with the plain version at {name}")
    del out, ref, p
    torch.cuda.empty_cache()
    return err, k_ms, p_ms


def phase_packed_kernel(dev, tag):
    path_case = None
    nt = N_PACKED // W_PACKED
    for k in (0, nt // 2):
        for prec in ("default", "high", "highest"):
            r = packed_case(dev, tag, N_PACKED, W_PACKED, KTB_PACKED, k, torch.float32, prec,
                            iters=2)
            if k == 0 and prec == PACKED_KW["precision"]:
                path_case = r
    packed_case(dev, tag, N_PACKED, W_PACKED, KTB_PACKED, 0, torch.bfloat16, "high", iters=2)
    packed_case(dev, tag, N_PACKED64, W_PACKED, KTB_PACKED, 0, torch.float64, "high", iters=2)
    for k in (0, 1):  # w not a multiple of the 64-wide block: blocks straddle slabs
        packed_case(dev, tag, 384, 96, 32, k, torch.float32, "high", iters=5)
    return path_case


# ---- 7. the packed path -------------------------------------------------------
def phase_packed_path(dev, tag):
    import dla_tpu_torch as T
    from dla_tpu_torch.kernels import tiles

    n, w = N_PACKED, W_PACKED
    per_fact = n // w - 1
    times = []
    tiles.packed_launches = 0
    for rep in range(3):  # repeat 0 is the warm-up
        a = T.plgsy_packed(n, w, seed=51, device=dev)
        sync()
        before = tiles.packed_launches
        t0 = time.perf_counter()
        l = T.potrf_packed(a, n, w, **PACKED_KW)
        sync()
        dt = time.perf_counter() - t0
        require(l is a, "potrf_packed did not factor its buffer in place")
        require(tiles.packed_launches - before == per_fact,
                f"{tiles.packed_launches - before} packed kernel launches in one "
                f"factorization, expected {per_fact}")
        print(f"packed path N={n} w={w} fp32 default: repeat {rep} {dt * 1e3:.1f} ms "
              f"{n**3 / 3 / dt / 1e9:.2f} GFLOP/s{' (warm-up)' if rep == 0 else ''} {tag}",
              flush=True)
        if rep:
            times.append(dt)
        del a
    launches = tiles.packed_launches
    require(launches == 3 * per_fact, "packed path launch count")
    tmed = statistics.median(times)
    print(f"packed path N={n} fp32 default: median {tmed * 1e3:.1f} ms, "
          f"{n**3 / 3 / tmed / 1e9:.2f} GFLOP/s, {launches} packed kernel launches "
          f"({per_fact} per factorization), {l.numel() * l.element_size() / 1e9:.2f} GB "
          f"packed buffer {tag}", flush=True)
    require(l.shape == (n * (n + w) // (2 * w), w) and bool(torch.isfinite(l).all()),
            "the packed factor has non-finite entries")
    res = float(T.freivalds_packed(l, n, w, seed=51))
    gate = n * 2e-7  # the driver's fp32 gate
    print(f"packed path freivalds ||(A - LL^T)x|| / (||A|| ||x||) = {res:.3e} (gate {gate:g})",
          flush=True)
    require(res < gate, "packed path Freivalds value above the fp32 gate")
    del l
    torch.cuda.empty_cache()
    return launches


# ---- 8. packed kernel path against plain path -------------------------------------
def phase_packed_check(dev):
    import dla_tpu_torch as T
    from dla_tpu_torch.kernels import tiles

    def factor(a, n, w, **kw):  # on the card, through the kernel
        before = tiles.packed_launches
        l = T.potrf_packed(a, n, w, **kw)
        sync()
        require(tiles.packed_launches - before == n // w - 1,
                "packed kernel launch count on the check path")
        return l

    n4, w4 = N_CHECK, N_CHECK // 4
    kw4 = dict(diag_factor="twolevel", ib=512, precision="high", trailing="pallas",
               ktb=w4 // 4, kb=w4)
    a_cpu = T.plgsy_packed(n4, w4, seed=7)
    lg = T.unpack_tri(factor(a_cpu.to(dev, copy=True), n4, w4, **kw4).cpu(), n4, w4)
    lc = T.unpack_tri(T.potrf_packed(a_cpu.clone(), n4, w4, **kw4), n4, w4)
    dl = (lg - lc).abs().max().item()
    print(f"packed N={n4} w={w4} fp32 high, kernel on the card vs plain on the CPU: "
          f"max|dL|={dl:.3e} (max|L|={lc.abs().max().item():.3e})", flush=True)
    require(dl <= 1e-5 * lc.abs().max().item(), "packed kernel-path L disagrees with plain")
    a64 = T.plgsy_packed(n4, w4, seed=7, dtype=torch.float64, device=dev)
    r64 = float(T.freivalds_packed(factor(a64, n4, w4, **kw4), n4, w4, seed=7))
    print(f"packed N={n4} fp64 kernel path freivalds {r64:.3e} (gate 1e-10)", flush=True)
    require(r64 < 1e-10, "packed fp64 Freivalds value above the reference's 1e-10 gate")
    nb16 = N_PACKED_BF16
    ab = T.plgsy_packed(nb16, W_PACKED, seed=51, dtype=torch.bfloat16, device=dev)
    rb = float(T.freivalds_packed(factor(ab, nb16, W_PACKED, **PACKED_KW), nb16, W_PACKED,
                                  seed=51))
    gate = nb16**0.5 * 2e-4
    print(f"packed N={nb16} bf16 storage kernel path freivalds {rb:.3e} (gate {gate:g})",
          flush=True)
    require(rb < gate, "packed bf16 Freivalds value above the bf16 gate")


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1

    from dla_tpu_torch.kernels import _build

    dev = torch.device(DEVICE)
    card = card_line()
    tag = f"[{card}]"

    # ---- 1. the card and the build ------------------------------------
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0 = {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(f"kernel build + load: {time.perf_counter() - t0:.3f} s ({_build.library_path().name}) "
          f"{tag}", flush=True)

    lower = phase_lower_kernel(dev, tag)                                  # 2
    lower_launches = phase_main_path(dev, tag)                            # 3
    phase_inplace_check(dev)                                              # 4
    phase_driver(tag, ["--n", str(N_MAIN), "--nb", str(NB_MAIN), "--dtype", "s",
                       "--mode", "inplace", "--repeats", "2"])            # 5
    torch.cuda.empty_cache()
    packed = phase_packed_kernel(dev, tag)                                # 6
    packed_launches = phase_packed_path(dev, tag)                         # 7
    phase_packed_check(dev)                                               # 8
    phase_driver(tag, ["--n", str(N_PACKED), "--nb", str(W_PACKED), "--dtype", "s",
                       "--mode", "packed", "--trailing", "pallas", "--precision", "default",
                       "--diag", "twolevel", "--kb", str(W_PACKED), "--repeats", "1"])  # 9

    rows = []
    for name, src, line, count, (err, k_ms, p_ms) in (
        ("trailing_update_lower", "trailing_lower.cu", 328, lower_launches, lower),
        ("trailing_update_packed", "trailing_packed.cu", 557, packed_launches, packed),
    ):
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"dla_tpu_torch/kernels/csrc/{src}",
            "replaces": f"dla_tpu/kernels/pallas_tiles.py:{line}",
            "launches": count,
            "max_abs_err": err,
            "ms": k_ms,
            "plain_ms": p_ms,
        })
    print(json.dumps({"kernels": rows}))
    print(f"chip_smoke total wall time: {time.perf_counter() - t_start:.1f} s {tag}", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
