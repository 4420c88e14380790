"""Analytic compute/comm scaling model of the distributed POTRF — counterpart
of ``dla_tpu/parallel/model.py``, for NVIDIA H100 cards.

Answers the reference's characterization question — *when does scaling
out pay?* The reference answered its analogue empirically: hybrid CPU+GPU
beats CPU-only at N ≥ ~12000 (SURVEY §6). Here the question is one card
against a mesh of cards over NVLink; with one card to measure on, the
answer is a *model*, the JAX package's arithmetic unchanged:

- **compute** comes from :func:`~dla_tpu_torch.parallel.potrf_dist.flop_accounting`
  (the per-step executed-flop geometry of the block-cyclic program) divided
  over devices at the single-card rates *measured on one H100* by
  ``python -m dla_tpu_torch.bench.calibrate_model``: the per-tier ceilings of
  the hand ``gemm_tile`` kernel chained back to back, and end-to-end POTRF
  curves of the port's bench;
- **comm** comes from the same accounting's per-step panel-broadcast
  volumes (:func:`step_comm_elems`);
- **overlap**: one step of lookahead, so a step costs
  ``chol + solve + max(trailing, comm)``.

The link figures are NVLink's public spec and two named assumptions
(``link_efficiency``, ``latency_us``) that one card cannot measure. The
model is a projection, not a measurement. Its validated parts are the flop
geometry and the comm volumes; its assumptions are constants a user can
override. The chip a projection is for is named by the caller; nothing
here looks at the device it runs on.

The framework-neutral accounting of the planes is here too: the packed
column-cyclic plane's ring broadcasts (which the tests pin to the real
program's ``ring_broadcast`` calls), the block-cyclic plane's per-step
panel broadcast and the out-of-core loop's volumes.
"""

from __future__ import annotations

import dataclasses
import math

from dla_tpu_torch.kernels.collectives import broadcast_chunks
from dla_tpu_torch.parallel.block_cyclic import BlockCyclicLayout
from dla_tpu_torch.parallel.potrf_dist import flop_accounting


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Per-card model parameters.

    tflops: sustained large-GEMM throughput per precision tier (TF/s).
    ici_gbps: aggregate link bandwidth per card, GB/s, one direction. For
      the H100 this is NVLink 4: 18 links, 450 GB/s per direction (public
      H100 SXM5 spec). The field keeps the JAX package's name.
    link_efficiency: achievable fraction of spec bandwidth.
    latency_us: per-collective launch+hop latency.
    hbm_gib: usable device memory per card — bounds the largest
      single-card N.
    hbm_gbps: memory stream bandwidth — rates the bandwidth-bound serving
      regime (parallel/serving.py).
    ici_links: how many links one ring hop's bandwidth is split over: the
      flat-ring data plane (kernels/collectives.ring_broadcast) streams to
      ONE neighbour per hop, so its bandwidth is ici_gbps / ici_links. On an
      HGX board every peer is one NVSwitch hop away over all 18 NVLinks, so
      a ring hop sees the aggregate and ici_links is 1, not 18.
    """

    tflops: dict
    ici_gbps: float
    link_efficiency: float
    latency_us: float
    hbm_gib: float
    hbm_gbps: float = 3350.0
    ici_links: int = 1


# The card every measured curve below was taken on: single_chip_rate and
# serving_rate scale the curves to another chip by its ceiling over this one's.
BASE_CHIP = "h100"

# H100 SXM5 80 GB HBM3. tflops and hbm_gib: measured by `python -m
# dla_tpu_torch.bench.calibrate_model --only ceilings` on an NVIDIA H100 80GB HBM3
# at a 700.00 W power limit (PERF.md, the projection model's calibration): gemm_tile (#8)
# chained back to back at m=n=k ∈ {8192, 16384}, the faster size, logical 2·m·n·k
# flops — `default` one bf16 plane (wgmma; 16384), `high` bf16x3 (wgmma; 8192),
# `highest` IEEE fp32 (simt; 16384); hbm_gib is torch.cuda.mem_get_info()'s total
# (85,017,493,504 bytes). hbm_gbps, ici_gbps: public H100 SXM5 spec.
# link_efficiency: an assumption — collectives rarely sustain more than about
# 80% of NVLink's line rate. latency_us: an assumption — one flagged hop of the
# ring kernel takes ≈ 1 µs on one card (chip_smoke.py phase 29), plus a round
# trip through the NVSwitch. Neither can be measured on one card.
CHIPS = {
    "h100": ChipSpec(
        tflops={"default": 432.3, "high": 228.4, "highest": 45.5},
        ici_gbps=450.0, link_efficiency=0.8, latency_us=3.0, hbm_gib=79.18,
        hbm_gbps=3350.0, ici_links=1,
    ),
}

# Measured single-card end-to-end POTRF rates (GF/s, (1/3)·N³ over the median
# of 3 timed factorizations after one warm-up, each point's gate passed) — the
# single-chip side of the crossover. Interpolated linearly in N; saturates at
# the last entry. Measured by `calibrate_model --only curves` in one run on an
# NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md's calibration table lists the run).
# `high`: potrf_inplace, nb=tb=kb=1024, ib=512, two-level diagonal factor, up to
# the largest N whose Freivalds gate fits beside the factor (122880 factored, its
# gate ran out of memory).
SINGLE_CHIP_HIGH_GFLOPS = {
    4096: 4618.7,
    8192: 16052.6,
    12288: 29277.4,
    16384: 43807.5,
    24576: 70098.4,
    32768: 89889.7,
    40960: 103880.6,
    49152: 115440.1,
    61440: 126172.5,
    81920: 133910.7,
    98304: 139818.1,
    114688: 143862.9,
}

# The HBM-bound tiers, best formulation per N (both ran from 32768 to 81920):
# dense `potrf_inplace` (as `high`) up to 81920, `potrf_packed` (w=nb=kb=4096,
# ktb=1024) beyond. The same run.
SINGLE_CHIP_DEFAULT_GFLOPS = {
    4096: 3016.6,
    8192: 14743.1,
    12288: 25898.0,
    16384: 44560.0,
    24576: 74709.1,
    32768: 101158.0,
    40960: 122494.9,
    49152: 141641.0,
    65536: 169387.7,
    81920: 185589.5,
    98304: 200572.6,  # packed
    131072: 231754.4,  # packed
    163840: 253906.9,  # packed
}

SINGLE_CHIP_BF16_GFLOPS = {
    4096: 2711.6,
    8192: 11273.2,
    12288: 28691.6,
    16384: 43272.6,
    24576: 72884.5,
    32768: 98444.5,
    40960: 120013.8,
    49152: 138566.1,
    65536: 165622.5,
    81920: 184675.2,
    106496: 207946.4,  # packed
    131072: 230570.6,  # packed
    163840: 253266.6,  # packed
}

# Emulated fp64 (df64, s=7) — LOGICAL N^3/3 flops: potrf_df64 (nb=1024,
# tb=512) dense up to 20480, potrf_packed_df64 (nb=1024, ktb=512, faster from
# 24576 on) beyond, each gated at 1e-10. The same run.
SINGLE_CHIP_DF64_GFLOPS = {
    4096: 198.1,
    8192: 600.7,
    12288: 1000.3,
    16384: 1385.6,
    20480: 1762.0,
    24576: 2130.4,  # packed
    32768: 2766.1,  # packed
    40960: 3374.5,  # packed
    49152: 3944.4,  # packed
}

# tier name → (measured curve, ChipSpec.tflops ceiling key used to scale the
# curve to other chips). "bf16" is the bf16-storage policy: its products run
# one bf16 plane, the `default` ceiling. "f64x" scales by the same one-plane
# ceiling: every df64 flop is a fixed number of bf16 tensor-core products.
SINGLE_CHIP_CURVES = {
    "high": (SINGLE_CHIP_HIGH_GFLOPS, "high"),
    "default": (SINGLE_CHIP_DEFAULT_GFLOPS, "default"),
    "bf16": (SINGLE_CHIP_BF16_GFLOPS, "default"),
    "f64x": (SINGLE_CHIP_DF64_GFLOPS, "default"),
}


def single_chip_rate(n: int, chip: str = "h100", tier: str = "high") -> float:
    """Projected single-card POTRF GF/s at size n (the curve measured on
    ``BASE_CHIP``, scaled by the chip's tier ceiling ratio elsewhere).

    ``highest`` has no measured curve and keeps the JAX package's rule: the
    ``high`` curve × the ceiling ratio (45.5 / 228.4 on the H100). On the
    H100 that is about 2× low: the port's ``highest`` path runs 2.04–2.05×
    this rate at N=32768 (``chip_smoke.py`` phase 40), so its projections
    (``project``, ``crossover_n`` at ``highest``) are low by about 2×."""
    # tiers without a measured curve (e.g. "highest") scale the high curve
    # by the ceiling ratio
    curve, ceil_key = SINGLE_CHIP_CURVES.get(
        tier, (SINGLE_CHIP_HIGH_GFLOPS, "high"))
    pts = sorted(curve.items())
    if tier in SINGLE_CHIP_CURVES:
        scale = CHIPS[chip].tflops[ceil_key] / CHIPS[BASE_CHIP].tflops[ceil_key]
    else:
        scale = CHIPS[chip].tflops[tier] / CHIPS[BASE_CHIP].tflops["high"]
    if n <= pts[0][0]:
        r = pts[0][1] * n / pts[0][0]
    elif n >= pts[-1][0]:
        r = pts[-1][1]
    else:
        for (n0, r0), (n1, r1) in zip(pts, pts[1:]):
            if n0 <= n <= n1:
                r = r0 + (r1 - r0) * (n - n0) / (n1 - n0)
                break
    return r * scale


def step_comm_elems(layout: BlockCyclicLayout, k: int) -> int:
    """Panel-broadcast volume of step k in elements — mirrors
    ``flop_accounting``'s aggregate ``(ltr-w0)·nb²·(q+p)`` term."""
    w0 = (k + 1) // layout.p
    return (layout.ltr - w0) * layout.nb * layout.nb * (layout.q + layout.p)


def project(
    layout: BlockCyclicLayout,
    *,
    chip: str = "h100",
    tier: str = "high",
    itemsize: int = 4,
) -> dict:
    """Projected wall time of the distributed POTRF on a p×q mesh.

    Per step k (geometry from ``flop_accounting(per_step=True)``):

    - serial phase: diag factor (one device, the others wait for it)
      + the panel solve on the kc column's p devices (each holds 1/p of
      the window) — the accounting's p-duplicated totals divided back per
      device;
    - overlapped phase: ``max(trailing/(p·q·R_dev), comm_k)`` — the 1-step
      lookahead hides the smaller of the two;
    - ``comm_k`` = step volume · itemsize / (link_bw · link_eff) +
      2 collectives · latency.

    Both sides of the comparison use the same measured size-dependent
    rate curve: the per-device rate is the measured single-card end-to-end
    rate at the device-local scale N/√(p·q) (each device holds N²/(p·q)
    elements), so the small-GEMM/panel-overhead penalty that the measured
    curve embodies applies to the distributed side too.

    Returns totals plus the single-card projection, speedup, and parallel
    efficiency (speedup / device count).
    """
    spec = CHIPS[chip]
    acc = flop_accounting(layout, per_step=True)
    n_local = max(1, int(layout.n / math.sqrt(layout.p * layout.q)))
    rate = single_chip_rate(n_local, chip, tier) * 1e9
    bw = spec.ici_gbps * 1e9 * spec.link_efficiency
    lat = spec.latency_us * 1e-6
    t_serial = t_overlap = t_comm_total = 0.0
    for s in acc["steps"]:
        k = s["k"]
        # accounting duplicates chol on the column's p devices (p·nb³/3) and
        # counts the column-total solve p times; per-device critical path:
        t_chol = (s["chol"] / layout.p) / rate
        t_solve = (s["solve"] / layout.p / layout.p) / rate
        t_trail = s["trail"] / (layout.p * layout.q) / rate
        comm_bytes = step_comm_elems(layout, k) * itemsize
        t_comm = comm_bytes / bw + 2 * lat
        t_serial += t_chol + t_solve
        t_overlap += max(t_trail, t_comm)
        t_comm_total += t_comm
    total = t_serial + t_overlap
    n = layout.n
    ideal_flops = n**3 / 3
    t_single = ideal_flops / (single_chip_rate(n, chip, tier) * 1e9)
    hbm_elems = spec.hbm_gib * 2**30 / itemsize
    # in-core bound of the JAX package's shrink path (peak ≈ 2·N² buffers)
    n_max_single = int(math.sqrt(hbm_elems / 2))
    return {
        "n": n, "p": layout.p, "q": layout.q, "nb": layout.nb,
        "chip": chip, "tier": tier,
        "t_dist_s": total, "t_serial_s": t_serial, "t_overlap_s": t_overlap,
        "t_comm_s": t_comm_total,
        "dist_gflops": ideal_flops / total / 1e9,
        "t_single_s": t_single,
        "single_gflops": ideal_flops / t_single / 1e9,
        "speedup": t_single / total,
        "efficiency": t_single / total / (layout.p * layout.q),
        "single_chip_fits": n <= n_max_single,
        "n_max_single": n_max_single,
        "comm_fraction": t_comm_total / total,
        "flop_ratio": acc["ratio"],
    }


def crossover_n(
    p: int,
    q: int,
    *,
    chip: str = "h100",
    tier: str = "high",
    nb: int = 2048,
    n_max: int = 262144,
) -> dict:
    """Smallest N (multiple of nb·lcm(p,q)) where the p×q mesh beats one
    card, plus the projection at that N and at the single-card HBM bound."""
    stride = nb * (p * q // math.gcd(p, q))
    first = eff50 = eff70 = None
    rows = []
    for n in range(stride, n_max + 1, stride):
        lay = BlockCyclicLayout(n=n, nb=nb, p=p, q=q)
        r = project(lay, chip=chip, tier=tier)
        rows.append(r)
        if first is None and r["speedup"] > 1.0:
            first = r
        if eff50 is None and r["efficiency"] >= 0.5:
            eff50 = n
        if eff70 is None and r["efficiency"] >= 0.7:
            eff70 = n
    return {
        "mesh": f"{p}x{q}", "chip": chip, "tier": tier, "nb": nb,
        "crossover_n": first["n"] if first else None,
        # the more decision-relevant thresholds: smallest N with ≥50%/70%
        # parallel efficiency (speedup alone crosses 1 early but poorly)
        "n_eff50": eff50,
        "n_eff70": eff70,
        "at_crossover": first,
        "curve": rows,
    }


# ---------------------------------------------------------------------------
# Out-of-core projection (N ≫ device memory)
# ---------------------------------------------------------------------------
#
# The reference's whole distributed design exists to serve N ≫ worker RAM.
# The port's analogue is `algos/oocore.py`: a left-looking panel stream over a
# host panel store. This model projects that pipeline (a) on the card's host
# at rates measured by the port's out-of-core driver, and (b) onto a mesh of
# cards with host staging at the measured pinned host → device rate.
#
# Volume geometry of the left-looking algorithm with panel width B
# (exact sums over panels, not the continuum approximations):
#   stream-in  = Σ_j (N − jB)·(jB + B)    elements  (≈ N³/6B)
#   compute    = N³/3 + O(N²B)            flops
#   writeback  = Σ_j (N − jB)·B           elements  (≈ N²/2)

@dataclasses.dataclass(frozen=True)
class OocoreHostCalib:
    """Rates of the one-card out-of-core driver on the card's host (fp32,
    panel 4096, nb=512, the panel store with its RAM cache): fitted on runs
    at N=32768 and 49152 after a warm-up at 16384, checked at 65536 (−1.3%
    in the fitting run), by ``calibrate_model --only oocore`` on an NVIDIA
    H100 80GB HBM3 at 700.00 W; PERF.md's calibration table lists each run.

    The JAX package's law is serial: products × overhead + stream/pack rate
    + writeback/rate. The port's loop overlaps the products with the packs,
    and each panel's pack and writeback through the store's file carry a
    fixed cost, so the law here adds the combo law's per-panel term; at
    ``panel_fixed_s=0`` it is JAX's.

    gemm_gflops: the update products' rate inside the fitting runs (device
      time of every ``_update`` call, by CUDA events).
    overhead: wall − pack − writeback = flops at ``gemm_gflops`` × overhead
      + npanels × a fixed cost, solved from the two fitting runs.
    pack_gibps / writeback_gibps: each of the runs' pack and writeback
      seconds solved as GiB / rate + npanels × a fixed cost.
    panel_fixed_s: the three fixed costs a panel, summed (rest 0.040, pack
      0.062, writeback 0.078 s).
    """

    gemm_gflops: float = 48499.2
    overhead: float = 0.535
    pack_gibps: float = 8.295
    writeback_gibps: float = 2.269
    panel_fixed_s: float = 0.1793


def oocore_volumes(n: int, panel: int, itemsize: int = 4) -> dict:
    """Exact stream/compute/writeback volumes of the left-looking loop.

    stream = the k-panel updates (h·jB per panel) **plus the panel's own
    one-time read** (h·B) — the driver's `bytes_in` exactly."""
    nt = -(-n // panel)
    stream_elems = sum(
        (n - j * panel) * (j * panel + panel) for j in range(nt)
    )
    wb_elems = sum((n - j * panel) * panel for j in range(nt))
    return {
        "n": n, "panel": panel, "npanels": nt,
        "stream_bytes": stream_elems * itemsize,
        "writeback_bytes": wb_elems * itemsize,
        "flops": n**3 / 3,
    }


def _oocore_law(n: int, panel: int, calib, itemsize: int) -> dict:
    """GEMM flops at the calibration's rate × overhead + a per-panel fixed
    cost, plus the stream at the pack rate and the writeback at its rate."""
    v = oocore_volumes(n, panel, itemsize)
    gib = 2.0**30
    t_compute = (v["flops"] / (calib.gemm_gflops * 1e9) * calib.overhead
                 + v["npanels"] * calib.panel_fixed_s)
    t_pack = v["stream_bytes"] / gib / calib.pack_gibps
    t_wb = v["writeback_bytes"] / gib / calib.writeback_gibps
    total = t_compute + t_pack + t_wb
    return {
        **v,
        "t_compute_s": t_compute, "t_pack_s": t_pack, "t_writeback_s": t_wb,
        "t_total_s": total,
        "gflops": v["flops"] / total / 1e9,
    }


def project_oocore_host(
    n: int,
    panel: int = 4096,
    *,
    calib: OocoreHostCalib = OocoreHostCalib(),
    itemsize: int = 4,
) -> dict:
    """Projected end-to-end seconds of the one-card out-of-core
    factorization on the card's host (validated at a third N in the run
    that fitted it)."""
    return _oocore_law(n, panel, calib, itemsize)


@dataclasses.dataclass(frozen=True)
class OocoreComboCalib:
    """Rates of the DISTRIBUTED out-of-core path: the panels split by rows
    over a 2×2 member mesh on one card (the out-of-core driver's ``--p 2
    --q 2``, RAM store): fitted on runs at N=32768 and 49152 after a warm-up
    at 16384, checked at 65536 (+4.2% in the fitting run), by
    ``calibrate_model --only combo`` on an NVIDIA H100 80GB HBM3 at 700.00 W;
    PERF.md's calibration table lists each run.

    gemm_gflops: the members' update products' rate inside the runs
      (device time of every ``_update`` call, by CUDA events).
    overhead, panel_fixed_s: the 2-term compute law (GEMM flops at
      ``gemm_gflops`` × overhead + a per-panel fixed cost) solved from the
      wall less pack and writeback of the two fitting runs.
    pack_gibps / writeback_gibps: the fitting runs' bytes over their pack and
      writeback seconds (the RAM store's rates fall with N: no per-panel
      term fits them).
    """

    gemm_gflops: float = 45701.4
    overhead: float = 0.426
    panel_fixed_s: float = 0.0772
    pack_gibps: float = 18.63
    writeback_gibps: float = 13.07


def project_oocore_combo(
    n: int,
    panel: int = 4096,
    *,
    calib: OocoreComboCalib = OocoreComboCalib(),
    itemsize: int = 4,
) -> dict:
    """Projected end-to-end seconds of the distributed out-of-core path
    (disk panel store × member-split update GEMMs). Same volume geometry as
    :func:`project_oocore_host`; compute is a 2-term law: GEMM flops at the
    measured update rate × ``overhead`` + a per-panel fixed cost, fitted on
    two runs and validated on a third."""
    return _oocore_law(n, panel, calib, itemsize)


# The pinned host → device copy rate, GB/s (bench/oocore_probe.py's "h2d from
# pinned": 131072 × 4096 fp32, best of 3), measured with OocoreHostCalib's runs
# by `calibrate_model --only oocore` on an NVIDIA H100 80GB HBM3 at 700.00 W;
# other hosts of the same card read 37.1–51.2 (PERF.md's calibration table).
HOST_BW_GBPS = 49.91
# #1's TF/s on the dense main path's shape (m=32768, nb=tb=1024, origin 0,
# `high`: 178.7 TF/s) over the `high` ceiling (228.4), both measured by one
# `calibrate_model --only ceilings` run.
COMPUTE_EFF = 0.782


def project_oocore_mesh(
    n: int,
    panel: int = 8192,
    p: int = 2,
    q: int = 4,
    *,
    chip: str = "h100",
    tier: str = "high",
    host_bw_gbps: float = HOST_BW_GBPS,
    compute_eff: float = COMPUTE_EFF,
    itemsize: int = 4,
) -> dict:
    """Project out-of-core POTRF on a p×q mesh of cards with host staging
    at ``host_bw_gbps`` (default: the measured pinned host → device rate).

    Per panel j the stream (in + writeback) overlaps the update GEMMs
    (double-buffered prefetch, `algos/oocore.py`); the panel factor+solve
    is serial. compute_eff is the measured trailing-kernel utilization
    fraction of the tier's ceiling.

    Returns the end-to-end projection plus which side binds and the
    minimum staging bandwidth for compute-bound operation.
    """
    spec = CHIPS[chip]
    rate = spec.tflops[tier] * 1e12 * compute_eff * p * q
    bw = host_bw_gbps * 1e9
    t_total = t_stream = t_compute = t_serial = 0.0
    nt = -(-n // panel)
    for j in range(nt):
        h = n - j * panel
        io_bytes = (h * (j * panel) + h * panel) * itemsize  # in + wb
        t_io = io_bytes / bw
        t_upd = 2.0 * h * panel * (j * panel) / rate
        # panel factor+solve: B³/3 on one column + h·B² solve flops
        t_fac = (panel**3 / 3 + h * panel**2) / rate
        t_total += max(t_io, t_upd) + t_fac
        t_stream += t_io
        t_compute += t_upd
        t_serial += t_fac
    flops = n**3 / 3
    # staging bandwidth at which Σ io time == Σ update time:
    # bw' = io_bytes / t_compute = (t_stream · bw) / t_compute
    min_bw_gbps = (
        bw * t_stream / t_compute / 1e9 if t_compute else float("inf")
    )
    hbm = spec.hbm_gib * 2**30
    panel_max = int(hbm / (2.5 * n * itemsize))  # ~2 panels + slack resident
    return {
        "n": n, "panel": panel, "mesh": f"{p}x{q}", "chip": chip,
        "tier": tier, "host_bw_gbps": host_bw_gbps,
        "t_total_s": t_total,
        "gflops": flops / t_total / 1e9,
        "stream_fraction": t_stream / (t_stream + t_compute + t_serial),
        "bound": "stream" if t_stream > t_compute else "compute",
        "min_bw_gbps_compute_bound": min_bw_gbps,
        "panel_max_by_hbm": panel_max,
        "panel_fits_hbm": panel <= panel_max,
    }


# ---------------------------------------------------------------------------
# Packed column-cyclic projection
# ---------------------------------------------------------------------------
#
# `parallel/packed_cyclic.py` combines triangle-only packed storage with the
# flat-mesh column-cyclic distribution (the ring data plane). Per-device
# resident memory is ≈ n²/(2·D) + n·nb/2 (`packed_cyclic.resident_elems`),
# so a D-card mesh holds a √2× larger in-core N than the dense
# column-cyclic path on top of the packed single-card gain. The model:
#
# - the flop accounting below mirrors `_potrf_local_packed`'s loop
#   EXACTLY (SPMD-executed convention: masked lanes still execute — every
#   device runs identical shapes);
# - the comm term counts the two per-step `ring_broadcast` operands, which
#   the tests pin to the real program's calls;
# - the ring streams to ONE neighbour per hop, so its bandwidth is
#   ici_gbps / ici_links; each broadcast is charged the EXACT time law of
#   the implemented chunk-pipelined kernel (kernels/collectives.py):
#   (C + D − 2)·(V/(C·link_bw) + lat) with C = broadcast_chunks(rows, D)
#   — imported from the kernel module, so the charged C is the C the data
#   plane actually uses. With C = 1 this is store-and-forward's
#   (D − 1)·(V/link_bw + lat); latency is charged per ACTUAL broadcast (the
#   last step has no panel broadcast);
# - NO lookahead overlap is credited: the packed-cyclic program is
#   broadcast-then-update in program order — the model charges
#   t_fac + t_bcast + t_trail per step.

# The share of hbm_gib the packed layout may fill: packed_mesh_max_n(1) then
# gives 180224, the largest fp32 N (stride 4096) that potrf_packed (w=4096,
# `default`) factored on one card with its Freivalds gate passed; 184320 ran out
# of memory (`calibrate_model --only frontier` on an NVIDIA H100 80GB HBM3 at
# 700.00 W).
PACKED_FILL = 0.782


def packed_cyclic_accounting(n: int, nb: int, ndev: int) -> dict:
    """Exact per-step executed flops and ring-broadcast element volumes of
    ``packed_cyclic._potrf_local_packed`` (same geometry helpers)."""
    nt = n // nb
    if n % nb or nt % ndev:
        raise ValueError("need nb | n and ndev | nt")
    ltc = nt // ndev
    hs = [(nt - lj * ndev) * nb for lj in range(ltc)]
    steps = []
    exec_total = 0.0
    for k in range(nt):
        ljk = k // ndev
        chol = nb**3 / 3.0
        solve_rows = hs[ljk] - nb
        solve = float(solve_rows) * nb * nb
        # two broadcasts: the nb×nb factor tile always; the solved panel
        # except after the last step
        bcast = nb * nb + (solve_rows * nb if k < nt - 1 else 0)
        # trailing: every device executes 2·hs[lj]·nb² for each slab group
        # lj that has ANY live column (lj·D + D−1 > k); dead lanes are
        # where-masked but still executed (SPMD)
        trail_dev = 0.0
        if k < nt - 1:
            for lj in range(ltc):
                if lj * ndev + ndev - 1 <= k:
                    continue
                trail_dev += 2.0 * hs[lj] * nb * nb
        steps.append({
            "k": k, "chol": chol, "solve": solve,
            "bcast_elems": bcast, "trail_per_dev": trail_dev,
            # the two ring broadcasts' row counts — the time law needs the
            # buffer geometry, not just the volume (chunk count is a
            # function of rows)
            "bcast_rows": (nb, solve_rows if k < nt - 1 else 0),
        })
        # exec_total is the CRITICAL-PATH convention for the factor/solve
        # terms (charged once — non-owners wait on the broadcast regardless,
        # so duplicated execution would not change wall time) and the
        # SPMD-executed convention for the trailing term (masked lanes still
        # execute identical shapes — ×ndev is real work).
        exec_total += chol + solve + trail_dev * ndev
    ideal = n**3 / 3.0
    return {
        "n": n, "nb": nb, "ndev": ndev, "steps": steps,
        "executed": exec_total, "ideal": ideal,
        "ratio": exec_total / ideal,
        "bcast_elems_total": sum(s["bcast_elems"] for s in steps),
    }


def packed_resident_bytes(n: int, nb: int, ndev: int,
                          itemsize: int = 4) -> int:
    """Per-device resident bytes of the packed column-cyclic layout
    (envelope-padded slabs — the exact `resident_elems` sum)."""
    nt = n // nb
    ltc = nt // ndev
    return sum((nt - lj * ndev) * nb for lj in range(ltc)) * nb * itemsize


def packed_mesh_max_n(
    ndev: int,
    *,
    chip: str = "h100",
    nb: int = 4096,
    itemsize: int = 4,
    fill: float | None = None,
) -> dict:
    """Largest in-core N (multiple of nb·ndev) on a D-card flat mesh for
    the packed column-cyclic layout vs the dense column-cyclic one.

    ``fill`` (default :data:`PACKED_FILL`) reserves headroom for the
    broadcast panel + program temporaries; the default reproduces the
    measured single-card packed fp32 frontier."""
    if fill is None:
        fill = PACKED_FILL
    budget = CHIPS[chip].hbm_gib * 2**30 * fill
    n = nb * ndev
    best_packed = best_dense = 0
    while True:
        if packed_resident_bytes(n, nb, ndev, itemsize) <= budget:
            best_packed = n
        else:
            break
        n += nb * ndev
    n = nb * ndev
    while True:
        dense = (n // ndev) * n * itemsize  # full local columns
        if dense <= budget:
            best_dense = n
        else:
            break
        n += nb * ndev
    return {
        "ndev": ndev, "chip": chip, "nb": nb, "itemsize": itemsize,
        "fill": fill, "max_n_packed": best_packed, "max_n_dense": best_dense,
        "unlock_ratio": best_packed / best_dense if best_dense else None,
    }


def project_packed_cyclic(
    n: int,
    nb: int,
    ndev: int,
    *,
    chip: str = "h100",
    tier: str = "default",
    itemsize: int = 4,
    planes: int = 1,
) -> dict:
    """Projected wall time of the packed column-cyclic POTRF on a flat
    D-device mesh (see the section comment for the term-by-term model).

    The single-card comparison side uses the same measured tier curve;
    ``single_chip_fits`` reports whether N is in-core for the *packed*
    single-card layout (n·(n+nb)/2 elements, within :data:`PACKED_FILL` of
    the card's memory) — beyond it the mesh is the only in-core option and
    ``speedup`` compares against the saturated curve rate, which flatters
    the (infeasible) single card."""
    spec = CHIPS[chip]
    acc = packed_cyclic_accounting(n, nb, ndev)
    n_local = max(1, int(n / math.sqrt(ndev)))
    rate = single_chip_rate(n_local, chip, tier) * 1e9
    link_bw = spec.ici_gbps / spec.ici_links * 1e9 * spec.link_efficiency
    lat = spec.latency_us * 1e-6

    def t_bcast(rows: int) -> float:
        # the implemented chunk-pipelined ring kernel's exact time law
        # (kernels/collectives.py): C+D−2 hops of one chunk each. The
        # df64 plane (planes=2) stacks (hi, lo) into ONE buffer per
        # broadcast, so the kernel sees planes·rows buffer rows.
        if ndev <= 1 or rows == 0:
            return 0.0
        c = broadcast_chunks(planes * rows, ndev)
        return (c + ndev - 2) * (
            planes * rows * nb * itemsize / (c * link_bw) + lat)

    t_fac = t_comm = t_trail = 0.0
    for s in acc["steps"]:
        t_fac += (s["chol"] + s["solve"]) / rate
        tile_rows, panel_rows = s["bcast_rows"]
        t_comm += t_bcast(tile_rows) + t_bcast(panel_rows)
        t_trail += s["trail_per_dev"] / rate
    total = t_fac + t_comm + t_trail
    ideal = n**3 / 3.0
    t_single = ideal / (single_chip_rate(n, chip, tier) * 1e9)
    hbm = spec.hbm_gib * 2**30
    single_fits = planes * n * (n + nb) / 2 * itemsize <= hbm * PACKED_FILL
    return {
        "n": n, "nb": nb, "ndev": ndev, "chip": chip, "tier": tier,
        "t_dist_s": total, "t_fac_s": t_fac, "t_comm_s": t_comm,
        "t_trail_s": t_trail,
        "dist_gflops": ideal / total / 1e9,
        "t_single_s": t_single,
        "single_gflops": ideal / t_single / 1e9,
        "speedup": t_single / total,
        "efficiency": t_single / total / ndev,
        "comm_fraction": t_comm / total,
        "flop_ratio": acc["ratio"],
        "single_chip_fits": single_fits,
        "resident_bytes_per_dev": planes * packed_resident_bytes(
            n, nb, ndev, itemsize),
        "planes": planes,
    }


def packed_crossover(
    ndev: int,
    *,
    chip: str = "h100",
    tier: str = "default",
    nb: int = 4096,
    itemsize: int = 4,
    planes: int = 1,
) -> dict:
    """Scan N (multiples of nb·ndev) up to the mesh's packed in-core bound:
    smallest N where the flat mesh beats one card, the ≥50%/70% efficiency
    thresholds, and the projection at the bound (the memory-unlock point —
    the largest factorization the mesh can hold at all)."""
    bound = packed_mesh_max_n(
        ndev, chip=chip, nb=nb, itemsize=itemsize * planes)["max_n_packed"]
    first = eff50 = eff70 = None
    rows = []
    for n in range(nb * ndev, bound + 1, nb * ndev):
        r = project_packed_cyclic(
            n, nb, ndev, chip=chip, tier=tier, itemsize=itemsize,
            planes=planes)
        rows.append(r)
        if first is None and r["speedup"] > 1.0:
            first = r
        if eff50 is None and r["efficiency"] >= 0.5:
            eff50 = n
        if eff70 is None and r["efficiency"] >= 0.7:
            eff70 = n
    return {
        "ndev": ndev, "chip": chip, "tier": tier, "nb": nb,
        "planes": planes, "mesh_max_n": bound,
        "crossover_n": first["n"] if first else None,
        "n_eff50": eff50, "n_eff70": eff70,
        "at_mesh_max": rows[-1] if rows else None,
        "curve": rows,
    }
