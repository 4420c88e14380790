"""Measure on one card every figure of the projection model
(``dla_tpu_torch/parallel/model.py`` and ``serving.py``).

    python -m dla_tpu_torch.bench.calibrate_model --only ceilings
    python -m dla_tpu_torch.bench.calibrate_model --only curves --tiers high,default
    python -m dla_tpu_torch.bench.calibrate_model --only serving,frontier
    python -m dla_tpu_torch.bench.calibrate_model --only nvlink      # a host of 2+ cards

Parts (``--only``, comma-separated; each fits one call of about 20 minutes):

- ``ceilings``: the hand ``gemm_tile`` (#8) chained back to back at square
  m=n=k ∈ {8192, 16384} for each tier's body (``default`` one bf16 plane and
  ``high`` bf16x3 on ``wgmma``, ``highest`` on ``simt``), logical 2·m·n·k
  flops → ``ChipSpec.tflops``; the card's memory from
  ``torch.cuda.mem_get_info`` → ``hbm_gib``; #1 at the dense main path's
  shape (m=32768, nb=tb=1024, origin 0, ``high``) over the ``high`` ceiling →
  ``COMPUTE_EFF``.
- ``curves``: end-to-end POTRF rates through the port's bench
  (``bench.run_tier``, ``run_tier_packed``, ``run_tier_df64``; one warm-up, 3
  timed factorizations, the median; a point counts only with its gate passed)
  over a ladder of N per tier (``--tiers``), dense and packed where both run;
  the curve keeps the faster per N. The packed df64 points go through
  ``potrf_packed_df64`` timed the bench's way, gated by
  ``freivalds_packed_df64`` at 1e-10.
- ``serving``: ``solve_inverse`` on a resident fp32 A⁻¹ at N=16384, nrhs ∈
  {1, 128, 1024}, mean of back-to-back calls by CUDA events, at 2·N²·nrhs →
  ``SERVING_RATE_GFLOPS``.
- ``oocore``: the pinned host → device rate (2 GiB, best of 3) →
  ``HOST_BW_GBPS``; the out-of-core driver in this process (panel 4096,
  nb=512, the panel store with its RAM cache), each update product timed by
  CUDA events: a warm-up at N=16384 (it pays the process's first pinning and
  thread start), runs at N ∈ {32768, 49152} to fit ``OocoreHostCalib``, one
  at 65536 to check the fit within 15%.
- ``combo``: the same runs on a 2×2 member mesh (``--p 2 --q 2``, RAM store)
  → ``OocoreComboCalib``, checked within 10%.

  Both laws: the products' rate over every fitting product; wall − pack −
  writeback = flops at that rate × overhead + npanels × a fixed cost, solved
  exactly from the two fitting runs. The panel store's pack and writeback go
  through a file a panel, whose fixed cost makes their rates rise with N: each
  is fitted as GiB / rate + npanels × a fixed cost. The RAM store's rates
  fall with N instead, which such a fit would extrapolate the wrong way: each
  is the fitting runs' bytes over their seconds.
- ``frontier``: the largest fp32 N (stride 4096) that ``potrf_packed``
  (w=4096, ``default``) factors with its Freivalds gate passed →
  ``PACKED_FILL``.
- ``nvlink`` (two or more cards, built for four): #11 ``ring_broadcast``
  across D cards, one fp64 member each, at V = m·1024·8 bytes for m ∈
  ``NVLINK_ROWS``, with the caller's chunk count C = ``broadcast_chunks(m,
  D)`` (the plain version's; the kernel pipelines its own segments), at each
  cut of ``NVLINK_CUTS`` (blocks per SM, least bytes a block copies between
  flags: ``collectives.ring_plan``), the mean of back-to-back
  calls between two waits
  for every card and the cards' time (calls queued behind a sleeping kernel
  on every card, the longest card's CUDA-event span); per cut, over the
  cards' times, ``(C + D − 2)·(V/(C·bw) + lat)`` fitted by least
  squares (linear in 1/bw and lat) over the sizes; the fastest cut (the
  least sum of the cards' times) → ``collectives.NVLINK_CUT``, its fit →
  ``link_efficiency`` (bw over the spec's 450 GB/s) and ``latency_us``. Then
  the block plane's per-step broadcast (the strips of a step delivered to
  the cards that read them, ``potrf_dist._stacked``) on 2×2 over the cards
  at N=49152, nb=2048, fp32, at several steps k, against the model's
  ``step_comm_elems(layout, k)``·4 / (450 GB/s·efficiency) + 2·latency
  (the cards' time, queued as above).

It prints one JSON line per measurement, then the Python literals for the
model's modules. It needs a card: without one it exits with code 2.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch

DEVICE = "cuda"
PARTS = ("ceilings", "curves", "serving", "oocore", "combo", "frontier", "nvlink")
TIERS = ("high", "default", "bf16", "f64x")
# the ladders: (bench tier spec with {n}, the N to run it at)
CEILING_MS = (8192, 16384)  # gemm_tile's square sizes
EFF_M, EFF_NB = 32768, 1024  # #1 on the dense main path's shape
_DENSE_SMALL = (4096, 8192, 12288, 16384, 24576, 32768, 40960, 49152)
LADDERS = {
    # at 122880 the factor fits on an 80 GB card but its Freivalds gate does not
    "high": [("high:inplace:1024:1024:{n}", _DENSE_SMALL + (61440, 81920, 98304, 114688))],
    "default": [("default:inplace:1024:1024:{n}", _DENSE_SMALL + (65536, 81920)),
                ("default:packed:4096:4096:{n}", (32768, 49152, 65536, 81920, 98304, 131072,
                                                  163840))],
    "bf16": [("bf16:inplace:1024:1024:{n}", _DENSE_SMALL + (65536, 81920)),
             ("bf16:packed:4096:4096:{n}", (32768, 49152, 65536, 81920, 106496, 131072,
                                            163840))],
    "f64x": [("f64x:7:1024:-:{n}", (4096, 8192, 12288, 16384, 20480, 24576, 32768)),
             ("f64x-packed:{n}", (24576, 32768, 40960, 49152))],
}
PDF64_NB, PDF64_KTB = 1024, 512  # the packed df64 points: the driver's configuration
CURVE_NAMES = {"high": "SINGLE_CHIP_HIGH_GFLOPS", "default": "SINGLE_CHIP_DEFAULT_GFLOPS",
               "bf16": "SINGLE_CHIP_BF16_GFLOPS", "f64x": "SINGLE_CHIP_DF64_GFLOPS"}
N_SERVING, SERVING_NRHS = 16384, (1, 128, 1024)
W_OOC, NB_OOC = 4096, 512  # the out-of-core runs' panel and nb (chip_smoke.py phase 35's)
# both out-of-core laws: a warm-up, two fitting runs, a check (smaller runs last
# well under a second, set by fixed costs)
N_LAW_WARM, N_LAW_FIT, N_LAW_CHECK = 16384, (32768, 49152), 65536
H2D_ROWS = 131072  # the pinned copy: 131072 × 4096 fp32, 2 GiB (bench/oocore_probe.py's)
HOST_BOUND, COMBO_BOUND = 0.15, 0.10
FRONTIER_W = 4096
ITERS = 3  # timed factorizations a curve point, after one warm-up
# nvlink: the broadcast's rows (× 1024 fp64 columns), the cuts tried (blocks per SM, least bytes a
# block copies between two flags), the calls timed a point; the block plane's step layout
NVLINK_ROWS, NVLINK_N = (128, 512, 1024, 4096, 15360), 1024
NVLINK_CUTS = ((1, 8 * 1024), (1, 16 * 1024), (1, 32 * 1024), (1, 64 * 1024), (2, 16 * 1024))
NVLINK_ITERS = 20
NVLINK_STEP = (49152, 2048, 2, 2)  # n, nb, p, q: the driver's 2x2 run of chip_smoke.py phase 41



def emit(part: str, **kw) -> dict:
    row = {"part": part, **kw}
    print(json.dumps(row), flush=True)
    return row


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def sync() -> None:
    torch.cuda.synchronize()


def events_ms(fn, iters: int) -> float:
    """Mean ms of ``fn`` on the card over ``iters`` back-to-back calls, after one."""
    fn()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---- ceilings --------------------------------------------------------------------------
def part_ceilings(card: str) -> dict:
    from dla_tpu_torch.kernels import tiles
    from dla_tpu_torch.utils import precision

    free, total = torch.cuda.mem_get_info()
    hbm_gib = total / 2**30
    emit("ceilings", what="hbm_gib", total_bytes=total, free_bytes=free, hbm_gib=hbm_gib,
         card=card)
    tflops = {}
    g = torch.Generator(device=DEVICE).manual_seed(24)
    for m in CEILING_MS:
        a = torch.randn(m, m, generator=g, device=DEVICE) / math.sqrt(m)
        b = torch.randn(m, m, generator=g, device=DEVICE)
        for tier in ("default", "high", "highest"):
            body = tiles.tile_op_body("gemm", torch.float32, tier)
            c = [torch.zeros(m, m, device=DEVICE)]

            def chained():
                c[0] = tiles.gemm_tile(c[0], a, b)

            with precision.override(tier):
                iters = 4 if tier == "highest" and m > CEILING_MS[0] else 10
                before = tiles.tile_body_launches()[body]
                ms = events_ms(chained, iters)
                ran = tiles.tile_body_launches()[body] - before
                ok = bool(torch.isfinite(c[0]).all())
            rate = 2.0 * m * m * m / (ms * 1e-3) / 1e12
            emit("ceilings", what="gemm_tile", tier=tier, body=body, launches=ran, m=m, n=m,
                 k=m, ms=ms, tflops=rate, finite=ok, card=card)
            if not ok or ran != iters + 1:
                raise RuntimeError(f"gemm_tile at {tier}, m={m}: {ran} launches through "
                                   f"{body}, finite output {ok}")
            tflops[tier] = max(tflops.get(tier, 0.0), rate)
            del c
        del a, b
        torch.cuda.empty_cache()
    # #1 on the dense main path's shape, over the high ceiling
    m, nb = EFF_M, EFF_NB
    cc = torch.randn(m, m, generator=g, device=DEVICE)
    p = torch.randn(m, nb, generator=g, device=DEVICE) / math.sqrt(nb)
    body = tiles.trailing_body(torch.float32, "high")
    with precision.override("high"):
        before = tiles.body_launches()[body]
        ms = events_ms(lambda: tiles.trailing_update_lower(cc, p, tb=nb, kb=nb, origin=0), 10)
        ran = tiles.body_launches()[body] - before
    if ran != 11:
        raise RuntimeError(f"trailing_update_lower: {ran} launches through {body}, not 11")
    nt = m // nb
    flops = 2.0 * (nt * (nt + 1) // 2) * nb * nb * nb
    rate = flops / (ms * 1e-3) / 1e12
    eff = rate / tflops["high"]
    emit("ceilings", what="trailing_update_lower", tier="high", body=body, m=m, nb=nb, tb=nb, origin=0,
         ms=ms, tflops=rate, compute_eff=eff, high_ceiling=tflops["high"], card=card)
    del cc, p
    torch.cuda.empty_cache()
    return {"tflops": tflops, "hbm_gib": hbm_gib, "compute_eff": eff}


# ---- curves ----------------------------------------------------------------------------
def _run_packed_df64(n: int, cfg: dict, device, bsync) -> dict:
    """The packed df64 formulation, timed as the bench times a tier."""
    from dla_tpu_torch.algos import plgsy_packed, potrf_packed_df64
    from dla_tpu_torch.algos.potrf_df64 import freivalds_packed_df64
    from dla_tpu_torch.bench.bench import _time_tier

    nb, s = PDF64_NB, 7

    def gen(_):
        h = plgsy_packed(n, nb, bump=float(n), seed=51, device=device)
        return h, torch.zeros_like(h)

    def factor(pair):
        return potrf_packed_df64(*pair, n, nb, ktb=PDF64_KTB, s=s)

    (lph, lpl), warmup_s, times = _time_tier(f"f64x_packed {n}", n, cfg["iters"], gen,
                                             factor, bsync)
    res = float(freivalds_packed_df64(lph, lpl, n, nb, gen_seed=51, bump=float(n), s=s,
                                      row_chunk=min(1024, n)))
    return {"residual": res, "validation": "df64-packed-freivalds", "warmup_s": warmup_s,
            "times": times}


def curve_point(spec: str, n: int, cfg: dict, card: str) -> dict | None:
    from dla_tpu_torch.bench import bench
    from dla_tpu_torch.cli.potrf_driver import _gate

    device = torch.device(DEVICE)
    spec = spec.format(n=n)
    t0 = time.perf_counter()
    try:
        if spec.startswith("f64x-packed"):
            form, gate = "packed", 1e-10
            r = _run_packed_df64(n, cfg, device, sync)
        else:
            t = bench.parse_tier(spec, nb=1024, kb=1024, n=n)
            if t["precision"] == "f64x":
                form, gate, runner = "dense", 1e-10, bench.run_tier_df64
            else:
                form, gate = t["formulation"], _gate(n, t["storage"])
                runner = bench.run_tier_packed if form == "packed" else bench.run_tier
            r = runner(t, cfg, device, sync)
    except torch.cuda.OutOfMemoryError as e:
        oom = str(e).splitlines()[0]
    else:
        oom = None
    gc.collect()  # the traceback's frames held the failed run's tensors
    torch.cuda.empty_cache()
    if oom:
        emit("curves", spec=spec, n=n, error="out of memory", detail=oom, card=card)
        return None
    tmed = statistics.median(r["times"])
    gflops = n**3 / 3 / tmed / 1e9
    passed = r["residual"] < gate
    return emit("curves", spec=spec, n=n, form=form, times_s=r["times"], median_s=tmed,
                gflops=gflops, residual=r["residual"], validation=r["validation"], gate=gate,
                passed=passed, warmup_s=r["warmup_s"], wall_s=time.perf_counter() - t0,
                card=card)


def part_curves(card: str, tiers) -> dict:
    cfg = {"iters": ITERS, "panel": "blocktrsm", "trailing": "pallas", "tb": 1024,
           "alias": False, "ib": 512,
           "diag_for": lambda p: "lax" if p == "highest" else "twolevel"}
    curves = {}
    for tier in tiers:
        best: dict[int, tuple[float, str]] = {}
        for spec, ns in LADDERS[tier]:
            for n in ns:
                row = curve_point(spec, n, cfg, card)
                if row is None:
                    break  # the next N of this formulation does not fit either
                if row["passed"] and row["gflops"] > best.get(n, (0.0, ""))[0]:
                    best[n] = (row["gflops"], row["form"])
        curves[tier] = dict(sorted(best.items()))
    return curves


# ---- serving ---------------------------------------------------------------------------
def part_serving(card: str) -> dict:
    import dla_tpu_torch as T
    import dla_tpu_torch.algos as TA
    from dla_tpu_torch.algos.potri import potri, solve_inverse
    from dla_tpu_torch.utils import precision

    n = N_SERVING
    with precision.override("high"):
        nb = min(1024, n)
        l = TA.potrf_inplace(T.plgsy(n, seed=51, device=DEVICE), nb=nb, tb=nb, kb=nb,
                             ib=nb // 2, diag_factor="twolevel")
        ainv = potri(torch.tril(l))
        del l
        rates = {}
        g = torch.Generator(device=DEVICE).manual_seed(24)
        for nrhs in SERVING_NRHS:
            b = torch.randn(n, nrhs, generator=g, device=DEVICE)
            ms = events_ms(lambda: solve_inverse(ainv, b), 50 if nrhs < 1024 else 20)
            x = solve_inverse(ainv, b)
            ref = ainv.double() @ b.double()
            err = float((x.double() - ref).abs().max() / ref.abs().max())
            del ref
            rate = 2.0 * n * n * nrhs / (ms * 1e-3) / 1e9
            emit("serving", n=n, nrhs=nrhs, ms=ms, gflops=rate, rel_err_vs_fp64=err, card=card)
            if not err < 1e-3:
                raise RuntimeError(f"solve_inverse at nrhs={nrhs}: {err:.3e} off the fp64 product")
            rates[nrhs] = rate
    del ainv
    torch.cuda.empty_cache()
    return rates


# ---- out of core -----------------------------------------------------------------------
def _oocore_run(argv, card: str, part: str) -> dict:
    """The out-of-core driver in this process, each update product timed by CUDA
    events; its stats, the products' seconds and flops, and the gate."""
    import dla_tpu_torch.algos.oocore as oocore_mod
    from dla_tpu_torch.cli import oocore_driver

    real = oocore_mod._update
    marks = []

    def timed_update(slabs, lk, w):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(slabs, lk, w)
        end.record()
        marks.append((start, end, 2.0 * sum(s.shape[0] for s in slabs) * w * w))
        return out

    buf = io.StringIO()
    oocore_mod._update = timed_update
    try:
        with contextlib.redirect_stdout(buf):
            rc = oocore_driver.main([str(a) for a in argv] + ["--device", DEVICE])
    finally:
        oocore_mod._update = real
        if "--matrix" in argv:  # a run's panel store lasts the run
            with contextlib.suppress(FileNotFoundError):
                os.remove(str(argv[argv.index("--matrix") + 1]))
    out = buf.getvalue()
    sync()
    stats = json.loads(re.search(r"^\[oocore\] stats: (.*)$", out, re.M).group(1))
    passed = rc == 0 and re.search(r"^PASS ", out, re.M) is not None
    gemm_s = sum(s.elapsed_time(e) for s, e, _ in marks) / 1e3
    gemm_flops = sum(f for _, _, f in marks)
    n = int(argv[argv.index("--n") + 1])
    row = emit(part, n=n, argv=[str(a) for a in argv], stats=stats, updates=len(marks),
               gemm_s=gemm_s, gemm_gflops=gemm_flops / gemm_s / 1e9 if marks else None, passed=passed,
               gate_line=(re.search(r"^freivalds .*$", out, re.M) or [""])[0], card=card)
    if not passed:
        print(out, file=sys.stderr)
        raise RuntimeError(f"the out-of-core driver at N={n} returned {rc} without PASS")
    return row


def _fit_law(runs, calib_cls, project, io_per_panel: bool):
    """The out-of-core law's figures from two fitting runs, and its check on a
    third: the products' rate over all fitting products; wall − pack −
    writeback = flops at that rate × overhead + npanels × fixed, solved exactly
    from the two runs. With ``io_per_panel`` (a file store) the pack's and the
    writeback's seconds are each GiB / rate + npanels × fixed, solved alike, and
    the three fixed costs add up to ``panel_fixed_s``; else (the RAM store)
    each rate is the fitting runs' bytes over their seconds."""
    from dla_tpu_torch.parallel import model

    fits, check = runs[:2], runs[2]
    gemm = (sum(r["gemm_s"] * r["gemm_gflops"] for r in fits)
            / sum(r["gemm_s"] for r in fits))  # all fitting products over their seconds

    def two_term(rows):  # y = a·x + b·npanels at both runs → (a, b)
        (x1, p1, y1), (x2, p2, y2) = rows
        det = x1 * p2 - x2 * p1
        return (y1 * p2 - y2 * p1) / det, (x1 * y2 - x2 * y1) / det

    vols, stats = [model.oocore_volumes(r["n"], W_OOC) for r in fits], [r["stats"] for r in fits]
    overhead, f_rest = two_term([(v["flops"] / (gemm * 1e9), v["npanels"],
                                  st["wall_s"] - st["pack_s"] - st["writeback_s"])
                                 for v, st in zip(vols, stats)])
    io = {}
    for key, nbytes in (("pack_s", "bytes_in"), ("writeback_s", "bytes_out")):
        if io_per_panel:
            io[key] = two_term([(st[nbytes] / 2**30, v["npanels"], st[key])
                                for v, st in zip(vols, stats)])
        else:
            io[key] = (sum(st[key] for st in stats) / sum(st[nbytes] / 2**30 for st in stats), 0.0)
    (s_pack, f_pack), (s_wb, f_wb) = io["pack_s"], io["writeback_s"]
    if min(s_pack, s_wb) <= 0:
        raise RuntimeError(f"the fit gives {s_pack} s/GiB a pack, {s_wb} s/GiB a writeback")
    calib = calib_cls(gemm_gflops=gemm, overhead=overhead, panel_fixed_s=f_rest + f_pack + f_wb,
                      pack_gibps=1 / s_pack, writeback_gibps=1 / s_wb)
    proj = {r["n"]: project(r["n"], W_OOC, calib=calib)["t_total_s"] for r in runs}
    err = proj[check["n"]] / check["stats"]["wall_s"] - 1
    return calib, proj, err, {"rest_s": f_rest, "pack_s": f_pack, "writeback_s": f_wb}


def _law_part(card: str, part: str, argv_for, io_per_panel: bool, calib_cls, project,
              bound: float):
    """The driver at N_LAW after a warm-up (it pays the process's first pinning
    and thread start); the law fitted on two runs, checked on the last."""
    runs = [_oocore_run(["--n", n, "--panel", W_OOC, "--nb", NB_OOC, "--probes", 2, *argv_for(n)],
                        card, part)
            for n in (N_LAW_WARM, *N_LAW_FIT, N_LAW_CHECK)][1:]
    calib, proj, err, fixed = _fit_law(runs, calib_cls, project, io_per_panel)
    check = runs[2]
    emit(part, what=calib_cls.__name__, calib=dataclasses.asdict(calib), panel_fixed_parts=fixed,
         fit={r["n"]: [r["stats"]["wall_s"], proj[r["n"]]] for r in runs[:2]},
         check_n=check["n"], check_wall_s=check["stats"]["wall_s"],
         check_projected_s=proj[check["n"]], check_rel_err=err, bound=bound,
         within=abs(err) <= bound, card=card)
    return calib, err


def part_oocore(card: str) -> dict:
    from dla_tpu_torch.bench.oocore_probe import _best
    from dla_tpu_torch.parallel import model

    n, w = H2D_ROWS, W_OOC
    pinned = torch.empty(n * w, dtype=torch.float32, pin_memory=DEVICE == "cuda")
    dev = torch.empty(n * w, dtype=torch.float32, device=DEVICE)
    s = _best(lambda: dev.copy_(pinned, non_blocking=True))
    h2d = n * w * 4 / s / 1e9
    emit("oocore", what="h2d from pinned", bytes=n * w * 4, s=s, gbps=h2d, card=card)
    del pinned, dev
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="dla_calib_") as tmp:
        calib, err = _law_part(
            card, "oocore", lambda n: ["--store", "panel", "--matrix", os.path.join(tmp, f"a{n}.bin"),
                                       "--ram-cache"], True,
            model.OocoreHostCalib, model.project_oocore_host, HOST_BOUND)
    return {"host_bw_gbps": h2d, "host": calib, "host_err": err}


def part_combo(card: str) -> dict:
    from dla_tpu_torch.parallel import model

    calib, err = _law_part(card, "combo", lambda n: ["--p", 2, "--q", 2], False,
                           model.OocoreComboCalib, model.project_oocore_combo, COMBO_BOUND)
    return {"combo": calib, "combo_err": err}


# ---- frontier --------------------------------------------------------------------------
def _packed_try(n: int, card: str) -> bool:
    """One fp32 packed factorization at N=n (w=4096, ``default``) and its gate."""
    from dla_tpu_torch.algos import freivalds_packed, plgsy_packed, potrf_packed
    from dla_tpu_torch.cli.potrf_driver import _gate

    t0 = time.perf_counter()
    p = l = None
    try:
        p = plgsy_packed(n, FRONTIER_W, seed=51, device=DEVICE)
        sync()
        t1 = time.perf_counter()
        l = potrf_packed(p, n, FRONTIER_W, precision="default", trailing="pallas", ktb=1024,
                         kb=FRONTIER_W, diag_factor="twolevel", ib=512)
        sync()
        t_fact = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated()
        res = float(freivalds_packed(l, n, FRONTIER_W, seed=51, key=1))
    except torch.cuda.OutOfMemoryError as e:
        oom = str(e).splitlines()[0]
    else:
        oom = None
    p = l = None
    gc.collect()  # the traceback's frames held the failed run's tensors
    torch.cuda.empty_cache()
    if oom:
        emit("frontier", n=n, fits=False, error="out of memory", detail=oom,
             s=time.perf_counter() - t0, card=card)
        return False
    passed = res < _gate(n, "float32")
    emit("frontier", n=n, fits=passed, factor_s=t_fact, gflops=n**3 / 3 / t_fact / 1e9,
         freivalds=res, peak_bytes=peak, s=time.perf_counter() - t0, card=card)
    return passed


def part_frontier(card: str, hbm_gib: float) -> dict:
    """Down from the N whose triangle fills 95% of the card until one passes,
    then up while the next one passes."""
    from dla_tpu_torch.parallel import model

    w = FRONTIER_W
    budget = 0.95 * hbm_gib * 2**30
    n = w
    while model.packed_resident_bytes(n + w, w, 1) <= budget:
        n += w
    torch.cuda.reset_peak_memory_stats()
    while n > w and not _packed_try(n, card):
        n -= w
    best = n
    for _ in range(8):  # the first try's N filled 95% of the card: a few steps up at most
        if not _packed_try(best + w, card):
            break
        best += w
    total = hbm_gib * 2**30
    lo = model.packed_resident_bytes(best, w, 1) / total
    hi = model.packed_resident_bytes(best + w, w, 1) / total
    fill = math.ceil(lo * 1000) / 1000  # three decimals, still below the next N's share
    if fill >= hi:
        fill = lo
    emit("frontier", what="PACKED_FILL", max_n=best, fill=fill, share_of_max_n=lo,
         share_of_next_n=hi, hbm_gib=hbm_gib, card=card)
    return {"max_n": best, "fill": fill}


# ---- literals --------------------------------------------------------------------------
# ---- NVLink --------------------------------------------------------------------------------
def _cards() -> list:
    return [torch.device("cuda", i) for i in range(min(4, torch.cuda.device_count()))]


def _cards_ms(fn, cards, iters: int) -> float:
    """Mean ms of ``fn`` over ``iters`` back-to-back calls between two waits for
    every card, after one."""
    fn()
    for c in cards:
        torch.cuda.synchronize(c)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    for c in cards:
        torch.cuda.synchronize(c)
    return (time.perf_counter() - t0) * 1e3 / iters


def _queued_cards_ms(fn, cards, iters: int) -> float:
    """The cards' time of ``fn`` a call: ``iters`` calls queued behind a
    sleeping kernel on every card, so that the host's enqueue is hidden; the
    longest of the cards' CUDA-event spans over ``iters``, after one."""
    fn()
    for c in cards:
        torch.cuda.synchronize(c)
    starts = []
    for c in cards:
        with torch.cuda.device(c):
            torch.cuda._sleep(50_000_000)  # ≈ 25 ms at the H100's clock
            starts.append(torch.cuda.Event(enable_timing=True))
            starts[-1].record()
    for _ in range(iters):
        fn()
    spans = []
    for c, start in zip(cards, starts):
        with torch.cuda.device(c):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        end.synchronize()
        spans.append(start.elapsed_time(end))
    return max(spans) / iters


def fit_ring(points) -> tuple[float, float]:
    """(bytes/s, seconds) fitting t = (C + D − 2)·(V/(C·bw) + lat) by least
    squares over ``points`` [(V bytes, C, D, seconds)]: linear in 1/bw, lat."""
    rows = [((c + d - 2) * v / c, c + d - 2) for v, c, d, _ in points]
    sxx = sum(a * a for a, _ in rows)
    sxy = sum(a * b for a, b in rows)
    syy = sum(b * b for _, b in rows)
    tx = sum(a * t for (a, _), (*_, t) in zip(rows, points))
    ty = sum(b * t for (_, b), (*_, t) in zip(rows, points))
    det = sxx * syy - sxy * sxy
    inv_bw, lat = (tx * syy - ty * sxy) / det, (sxx * ty - sxy * tx) / det
    return 1.0 / inv_bw, lat


def part_nvlink(card: str) -> dict:
    from dla_tpu_torch.kernels import collectives as C
    from dla_tpu_torch.parallel import BlockCyclicLayout, make_mesh, member_comm, model, potrf_dist

    cards = _cards()
    d = len(cards)
    if d < 2:
        raise RuntimeError("the nvlink part needs two or more cards")
    spec = model.CHIPS["h100"]
    fits = {}
    for bps, seg in NVLINK_CUTS:
        cut = {"blocks_per_sm": bps, "min_segment": seg}
        points = []
        for m in NVLINK_ROWS:
            xs = [torch.randn(m, NVLINK_N, device=c, dtype=torch.float64) for c in cards]
            outs = [torch.empty_like(x) for x in xs]
            chunks = C.broadcast_chunks(m, d)

            def launch():
                C._launch("ring_broadcast", xs, outs, gather=False, group=d, root=0, cut=cut)
            ms = _cards_ms(launch, cards, NVLINK_ITERS)
            card_ms = _queued_cards_ms(launch, cards, NVLINK_ITERS)
            ref = C.ring_broadcast_plain(xs, 0, chunks=chunks)
            same = all(torch.equal(o, r) for o, r in zip(outs, ref))
            if not same:
                raise RuntimeError(f"ring_broadcast at cut {cut}, m={m}: off the plain bits")
            v = m * NVLINK_N * 8
            points.append((v, chunks, d, card_ms / 1e3))
            emit("nvlink", what="ring_broadcast", cards=d, m=m, bytes=v, chunks=chunks,
                 blocks_per_sm=bps, min_segment=seg, ms=ms, card_ms=card_ms,
                 gbps=v / (card_ms / 1e3) / 1e9, card=card)
            del xs, outs, ref
        bw, lat = fit_ring(points)
        fits[(bps, seg)] = (bw, lat, sum(t for *_, t in points))
        emit("nvlink", what="fit", blocks_per_sm=bps, min_segment=seg, gbps=bw / 1e9,
             latency_us=lat * 1e6, total_ms=fits[(bps, seg)][2] * 1e3, card=card)
    (bps, seg), (bw, lat, _) = min(fits.items(), key=lambda kv: kv[1][2])
    eff = bw / 1e9 / spec.ici_gbps
    emit("nvlink", what="chosen", blocks_per_sm=bps, min_segment=seg, gbps=bw / 1e9,
         link_efficiency=eff, latency_us=lat * 1e6, card=card)
    # the block plane's per-step broadcast against the model's comm term
    n, nb, p, q = NVLINK_STEP
    lay = BlockCyclicLayout(n, nb, p, q)
    mesh = make_mesh(p, q)
    if len(mesh.cards) > 1:
        with member_comm.over(mesh):
            for k in (0, lay.ntiles // 4, lay.ntiles // 2, 3 * lay.ntiles // 4):
                w0 = (k + 1) // p
                shape = ((lay.ltr - w0) * nb, nb)
                owners = [r * q + k % q for r in range(p)]
                strips = [torch.randn(shape, device=mesh.device_of(m)) for m in owners]
                uses = potrf_dist._strips_used(lay, k, lambda r, c, k=k: (
                    (lj, potrf_dist._trail_products(r, c, k, lj, lay))
                    for lj in range((k + 1) // q, lay.ltc)))
                ms = _queued_cards_ms(lambda: potrf_dist._stacked(strips, owners, uses),
                                      mesh.cards, NVLINK_ITERS)
                elems = model.step_comm_elems(lay, k)
                want = elems * 4 / (spec.ici_gbps * 1e9 * eff) + 2 * lat
                crossed = sum(strips[r].numel() * 4 for card_, used in uses.items()
                              for r in used if mesh.device_of(owners[r]) != card_)
                emit("nvlink", what="block step broadcast", n=n, nb=nb, p=p, q=q, k=k, ms=ms,
                     step_comm_elems=elems, crossed_bytes=crossed, model_ms=want * 1e3,
                     card=card)
                del strips
    torch.cuda.empty_cache()
    return {"link_efficiency": eff, "latency_us": lat * 1e6, "nvlink_cut": (bps, seg)}


def literals(got: dict, card: str) -> str:
    src = f"# {card}: python -m dla_tpu_torch.bench.calibrate_model"
    lines = [src]
    if "tflops" in got:
        t = got["tflops"]
        lines.append(f'tflops={{"default": {t["default"]:.1f}, "high": {t["high"]:.1f}, '
                     f'"highest": {t["highest"]:.1f}}}, hbm_gib={got["hbm_gib"]:.2f}')
        lines.append(f"COMPUTE_EFF = {got['compute_eff']:.3f}")
    for tier, curve in got.get("curves", {}).items():
        lines.append(f"{CURVE_NAMES[tier]} = {{")
        lines += [f"    {n}: {g:.1f},  # {form}" for n, (g, form) in curve.items()]
        lines.append("}")
    if "serving" in got:
        lines.append("SERVING_RATE_GFLOPS = {"
                     + ", ".join(f"{k}: {v:.1f}" for k, v in got["serving"].items()) + "}")
    if "host_bw_gbps" in got:
        lines.append(f"HOST_BW_GBPS = {got['host_bw_gbps']:.2f}")
        lines.append(repr(got["host"]))
    if "combo" in got:
        lines.append(repr(got["combo"]))
    if "fill" in got:
        lines.append(f"PACKED_FILL = {got['fill']}  # max N {got['max_n']}")
    if "link_efficiency" in got:
        lines.append(f"link_efficiency={got['link_efficiency']:.3f}, "
                     f"latency_us={got['latency_us']:.2f}")
        bps, seg = got["nvlink_cut"]
        lines.append(f"NVLINK_CUT = dict(blocks_per_sm={bps}, min_segment={seg})")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(PARTS),
                    help=f"comma-separated parts: {', '.join(PARTS)} (default: all)")
    ap.add_argument("--tiers", default=",".join(TIERS),
                    help=f"the curves' tiers: {', '.join(TIERS)} (default: all)")
    args = ap.parse_args(argv)
    parts = args.only.split(",")
    tiers = args.tiers.split(",")
    if not set(parts) <= set(PARTS) or not set(tiers) <= set(TIERS):
        ap.error(f"--only takes {PARTS}, --tiers takes {TIERS}")
    if not torch.cuda.is_available():
        print("calibrate_model: no CUDA device (torch.cuda.is_available() is False); the "
              "model's figures are measured on the card only", file=sys.stderr)
        return 2
    from dla_tpu_torch.kernels import _build

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(f"kernel build + load: {time.perf_counter() - t0:.1f} s", flush=True)
    got: dict = {}
    if "ceilings" in parts:
        got.update(part_ceilings(card))
    if "serving" in parts:
        got["serving"] = part_serving(card)
    if "curves" in parts:
        got["curves"] = part_curves(card, tiers)
    if "oocore" in parts:
        got.update(part_oocore(card))
    if "combo" in parts:
        got.update(part_combo(card))
    if "frontier" in parts:
        got.update(part_frontier(card, got.get("hbm_gib",
                                               torch.cuda.mem_get_info()[1] / 2**30)))
    if "nvlink" in parts:
        got.update(part_nvlink(card))
    print(literals(got, card), flush=True)
    print(f"calibrate_model: {time.perf_counter() - t0:.1f} s, parts {parts}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
