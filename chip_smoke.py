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
9. the driver with ``--mode packed --trailing pallas`` at phase 7's size;
10. the df64 trailing-update kernel against its plain version on the card at
    the f64x path's shapes (m=24576, tb=512, nb=1024, s=7, w=8, origin 0 and
    24), plus an nk=2 case (w=9) and a tb=96 case: both planes must come back
    **bit-identical** to the plain version, elements outside the visited
    tiles bit-unchanged, one launch per call; kernel and plain times, and the
    kernel's rate counted as s(s+1)/2 = 28 one-pass products;
11. the f64x path, the reference's emulated-fp64 tier: ``plgsy(24576)`` in
    fp32 with lo = 0 → ``potrf_df64(nb=1024, s=7, trailing="pallas",
    tb=512)``, one warm-up and two timed repeats, the kernel launched
    N/nb − 1 = 23 times per factorization, the blocked df64 residual under
    1e-10 and the native fp64 residual of the same factor under it;
    then the port's native fp64 ``potrf_inplace`` at the same N, timed once
    beside it;
12. the df64 kernel path against the plain path: N=4096 factored on the card
    and through the plain versions on the CPU, max|ΔL| ≤ 1e-12·max|L|, both
    df64 residuals under 1e-10;
13. the driver with ``--mode df64 --trailing pallas`` at phase 11's size.

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
# the f64x path: the reference's emulated-fp64 tier (bench.py:536-611)
N_DF64, NB_DF64, TB_DF64, S_DF64 = 24576, 1024, 512, 7
DF64_KW = dict(nb=NB_DF64, s=S_DF64, trailing="pallas", tb=TB_DF64)
N_DF64_CHECK = 4096


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


# ---- 10. the df64 kernel against its plain version -------------------------------
def df64_case(dev, tag, m, nb, tb, s, w, origin, iters):
    from dla_tpu_torch.kernels import df64_tiles
    from dla_tpu_torch.kernels.df64_tiles import trailing_update_df64_plain
    from dla_tpu_torch.ops.df64 import slice_rows, to_df64

    g = torch.Generator(device=dev).manual_seed(m + 7 * nb + origin)
    ch, cl = to_df64(torch.randn(m, m, generator=g, device=dev, dtype=torch.float64))
    p = torch.randn(m - origin * tb, nb, generator=g, device=dev, dtype=torch.float64)
    sx = slice_rows(*to_df64(p), s=s, w=w)[0]
    del p
    kw = dict(origin=origin, tb=tb, w=w)
    ref = trailing_update_df64_plain(ch.clone(), cl.clone(), sx, **kw)
    out = (ch.clone(), cl.clone())
    before = df64_tiles.launches
    res = df64_tiles.trailing_update_df64(*out, sx, **kw)
    sync()
    require(res[0] is out[0] and res[1] is out[1] and df64_tiles.launches == before + 1,
            "df64 kernel did not update the pair in place with one launch")
    require(not torch.equal(out[0], ch), "the df64 kernel changed nothing")
    ti = torch.arange(m, device=dev) // tb
    visit = (ti[:, None] >= ti[None, :]) & (ti[:, None] >= origin) & (ti[None, :] >= origin)
    for o, c in zip(out, (ch, cl)):
        require(torch.equal(bits(torch.where(visit, 0, o)), bits(torch.where(visit, 0, c))),
                "elements outside the visited tiles changed")
    del visit, ch, cl
    same = all(torch.equal(bits(o), bits(r)) for o, r in zip(out, ref))
    err = max((o - r).abs().max().item() for o, r in zip(out, ref))
    k_ms = cuda_ms(lambda: df64_tiles.trailing_update_df64(*out, sx, **kw), iters)
    p_ms = cuda_ms(lambda: trailing_update_df64_plain(*ref, sx, **kw), iters)
    nt = m // tb - origin
    flops = 2 * (nt * (nt + 1) // 2) * tb * tb * nb * (s * (s + 1) // 2)
    name = f"m={m} tb={tb} nb={nb} s={s} w={w} origin={origin}"
    print(f"trailing_update_df64 {name}: bits equal {same} (max_abs_err={err:.3e}) "
          f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, kernel {flops / k_ms / 1e9:.2f} TF/s "
          f"one-pass {tag}", flush=True)
    require(same, f"df64 kernel and plain version differ in their bits at {name}")
    del out, ref, sx
    torch.cuda.empty_cache()
    return err, k_ms, p_ms


def phase_df64_kernel(dev, tag):
    m, nb, tb, s = N_DF64, NB_DF64, TB_DF64, S_DF64
    path_case = df64_case(dev, tag, m, nb, tb, s, 8, 0, iters=2)
    df64_case(dev, tag, m, nb, tb, s, 8, m // tb // 2, iters=3)  # origin 24: the half-way step
    df64_case(dev, tag, 1024, 512, 128, 6, 9, 1, iters=5)  # nk = 2 chunks of kb = 256
    df64_case(dev, tag, 384, 128, 96, s, 8, 0, iters=5)  # tb not a multiple of 64
    return path_case


# ---- 11. the f64x path ------------------------------------------------------------
def phase_df64_path(dev, tag):
    import dla_tpu_torch as T
    from dla_tpu_torch.algos import potrf_df64, residual_potrf_df64_blocked
    from dla_tpu_torch.kernels import df64_tiles

    n = N_DF64
    per_fact = n // NB_DF64 - 1
    times = []
    df64_tiles.launches = 0
    for rep in range(3):  # repeat 0 is the warm-up
        lh = ll = None  # free the previous factor before the next input exists
        ah = T.plgsy(n, bump=float(n), seed=51, device=dev)
        al = torch.zeros_like(ah)
        sync()
        before = df64_tiles.launches
        t0 = time.perf_counter()
        lh, ll = potrf_df64(ah, al, **DF64_KW)
        sync()
        dt = time.perf_counter() - t0
        require(lh is ah and ll is al, "potrf_df64 did not factor its pair in place")
        require(df64_tiles.launches - before == per_fact,
                f"{df64_tiles.launches - before} df64 kernel launches in one factorization, "
                f"expected {per_fact}")
        print(f"f64x path N={n} df64 s={S_DF64}: repeat {rep} {dt * 1e3:.1f} ms "
              f"{n**3 / 3 / dt / 1e9:.2f} GFLOP/s{' (warm-up)' if rep == 0 else ''} {tag}",
              flush=True)
        if rep:
            times.append(dt)
        del ah, al
    launches = df64_tiles.launches
    require(launches == 3 * per_fact, "f64x path launch count")
    tmed = statistics.median(times)
    print(f"f64x path N={n}: median {tmed * 1e3:.1f} ms, {n**3 / 3 / tmed / 1e9:.2f} GFLOP/s, "
          f"{launches} df64 kernel launches ({per_fact} per factorization) {tag}", flush=True)
    require(lh.shape == (n, n) and bool(torch.isfinite(lh).all() and torch.isfinite(ll).all()),
            "the df64 factor has non-finite entries")
    a = T.plgsy(n, bump=float(n), seed=51, device=dev)
    res = residual_potrf_df64_blocked(a, None, lh, ll, s=S_DF64, rc=2048)
    l64 = lh.double() + ll.double()
    del lh, ll
    res64 = float(T.residual_potrf(a, l64, assume_symmetric=True, assume_tril=True,
                                   row_chunk=min(n, 4096)))
    print(f"f64x path ||A - LL^T||_inf / ||A||_inf = {res:.3e} (df64, blocked; gate 1e-10), "
          f"native fp64 {res64:.3e}", flush=True)
    require(res < 1e-10, "f64x path residual above the reference's 1e-10 gate")
    # The df64 value bounds the fp64 one from above: an |h|+|l| sum, with the
    # dropped slice pairs' and the lo plane's fp32 error on top. At this N
    # that floor, not the factor, sets it (~4e-11 against ~4e-13 in fp64).
    require(res64 <= res, "the native fp64 residual exceeds the df64 gate's value")
    del a, l64
    torch.cuda.empty_cache()
    a64 = T.plgsy(n, bump=float(n), seed=51, dtype=torch.float64, device=dev)
    sync()
    t0 = time.perf_counter()
    l64 = T.potrf_inplace(a64, nb=NB_DF64, tb=NB_DF64, kb=NB_DF64, ib=512,
                          diag_factor="twolevel")
    sync()
    dt64 = time.perf_counter() - t0
    r64 = float(T.residual_potrf(T.plgsy(n, bump=float(n), seed=51, dtype=torch.float64,
                                         device=dev), torch.tril(l64), assume_symmetric=True,
                                 assume_tril=True, row_chunk=min(n, 4096)))
    print(f"N={n} fp64 routes: df64 potrf_df64 {tmed * 1e3:.1f} ms "
          f"({n**3 / 3 / tmed / 1e9:.2f} GFLOP/s), native fp64 potrf_inplace "
          f"{dt64 * 1e3:.1f} ms ({n**3 / 3 / dt64 / 1e9:.2f} GFLOP/s, residual {r64:.3e}) "
          f"{tag}", flush=True)
    del a64, l64
    torch.cuda.empty_cache()
    return launches


# ---- 12. df64 kernel path against plain path ---------------------------------------
def phase_df64_check(dev):
    import dla_tpu_torch as T
    from dla_tpu_torch.algos import potrf_df64, residual_potrf_df64_blocked
    from dla_tpu_torch.kernels import df64_tiles
    from dla_tpu_torch.ops import from_df64

    n = N_DF64_CHECK
    a = T.plgsy(n, seed=7)
    before = df64_tiles.launches
    lg = potrf_df64(a.to(dev, copy=True), torch.zeros(n, n, device=dev), **DF64_KW)
    sync()
    require(df64_tiles.launches - before == n // NB_DF64 - 1,
            "df64 kernel launch count on the check path")
    lc = potrf_df64(a.clone(), torch.zeros(n, n), **DF64_KW)
    dl = (from_df64(*lg).cpu() - from_df64(*lc)).abs().max().item()
    lmax = from_df64(*lc).abs().max().item()
    ad = a.to(dev)
    r_gpu = residual_potrf_df64_blocked(ad, None, *lg, s=S_DF64, rc=2048)
    r_cpu = residual_potrf_df64_blocked(ad, None, lc[0].to(dev), lc[1].to(dev), s=S_DF64,
                                        rc=2048)
    print(f"df64 N={n}, kernel on the card vs plain on the CPU: max|dL|={dl:.3e} "
          f"(max|L|={lmax:.3e}), residuals {r_gpu:.3e} vs {r_cpu:.3e} (gate 1e-10)", flush=True)
    require(dl <= 1e-12 * lmax, "df64 kernel-path L disagrees with the plain path")
    require(r_gpu < 1e-10 and r_cpu < 1e-10, "df64 check residual above 1e-10")


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
    torch.cuda.empty_cache()
    df64 = phase_df64_kernel(dev, tag)                                    # 10
    df64_launches = phase_df64_path(dev, tag)                             # 11
    phase_df64_check(dev)                                                 # 12
    phase_driver(tag, ["--n", str(N_DF64), "--nb", str(NB_DF64), "--mode", "df64",
                       "--trailing", "pallas", "--repeats", "1"])         # 13

    rows = []
    for name, src, replaces, count, (err, k_ms, p_ms) in (
        ("trailing_update_lower", "trailing_lower.cu", "pallas_tiles.py:328", lower_launches,
         lower),
        ("trailing_update_packed", "trailing_packed.cu", "pallas_tiles.py:557",
         packed_launches, packed),
        ("trailing_update_df64", "trailing_df64.cu", "df64_tiles.py:110", df64_launches, df64),
    ):
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"dla_tpu_torch/kernels/csrc/{src}",
            "replaces": f"dla_tpu/kernels/{replaces}",
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
