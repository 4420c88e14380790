"""Profiling and roofline accounting — counterpart of
``dla_tpu/utils/profiling.py``.

The reference's profiling is wall-clock time around the factorization and
model flop counts (``v6_test.c:54-60``), plus the harness's calibration
repeat (``benchmark.c:201``). Here:

- :func:`time_fn`: warm-up calls, then the median of timed calls, each
  ended by ``torch.cuda.synchronize`` (the forced completion) on the card;
- :class:`Roofline`: per-op model flops against the card's peak;
- :func:`trace`: a ``torch.profiler`` context writing a Chrome trace.

The peaks are NVIDIA's data-sheet figures for the card this port is built
for, an NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit, dense: bf16 tensor
cores 989 TF/s; fp32 ``default`` one bf16 pass of them, ``high`` three
(bf16x3); fp32 ``highest`` (IEEE fp32, no TF32) and fp64 67 TF/s; df64 the
bf16 peak over s(s+1)/2 one-pass products (s = 7: 28). A card below 700 W
runs slower than these. ``DLA_TPU_PEAK_GFLOPS`` overrides every figure.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Sequence

#: GFLOP/s peaks of an NVIDIA H100 80GB HBM3 (SXM) at 700 W, dense
H100_BF16_GFLOPS = 989e3
H100_FP32_GFLOPS = 67e3
H100_FP64_GFLOPS = 67e3


def device_peak_gflops(dtype: str = "float32", precision: str | None = None,
                       slices: int = 7) -> float:
    """The card's peak GFLOP/s for ``dtype`` at ``precision`` (fp32 only; the
    default is ``DLA_TPU_MATMUL_PRECISION``, else ``highest``, as the
    reference), or ``DLA_TPU_PEAK_GFLOPS`` when set. ``df64`` is the bf16
    peak over s(s+1)/2 passes for ``slices`` = s."""
    env = os.environ.get("DLA_TPU_PEAK_GFLOPS")
    if env:
        return float(env)
    if dtype in ("bfloat16", "float16"):
        return H100_BF16_GFLOPS
    if dtype == "float32":
        prec = precision or os.environ.get("DLA_TPU_MATMUL_PRECISION", "highest")
        return {"default": H100_BF16_GFLOPS, "fastest": H100_BF16_GFLOPS,
                "high": H100_BF16_GFLOPS / 3}.get(prec, H100_FP32_GFLOPS)
    if dtype == "df64":
        return H100_BF16_GFLOPS / (slices * (slices + 1) // 2)
    return H100_FP64_GFLOPS  # float64 (and complex128 counted in real flops)


def force_result(x) -> None:
    """Force completion of ``x``'s computation: synchronize its CUDA device
    (nothing to wait for on the CPU)."""
    import torch

    t = x[0] if isinstance(x, (tuple, list)) else x
    if isinstance(t, torch.Tensor) and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def time_fn(
    fn: Callable,
    *args,
    iters: int = 3,
    warmup: int = 1,
    force: Callable = force_result,
) -> tuple[float, Sequence[float]]:
    """Median wall time of ``fn(*args)`` with forced completion, after
    ``warmup`` untimed calls. Returns (median_seconds, all_times)."""
    for _ in range(warmup):
        force(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        force(fn(*args))
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2], times


@dataclasses.dataclass
class RooflineEntry:
    name: str
    flops: float
    seconds: float
    gflops: float
    peak_fraction: float


class Roofline:
    """Accumulates per-op (name, model flops, seconds) and reports GFLOP/s
    and the fraction of the card's peak."""

    def __init__(self, dtype: str = "float32", peak_gflops: float | None = None,
                 precision: str | None = None):
        self.peak = peak_gflops or device_peak_gflops(dtype, precision)
        self.entries: list[RooflineEntry] = []

    def record(self, name: str, flops: float, seconds: float) -> RooflineEntry:
        g = flops / seconds / 1e9
        e = RooflineEntry(name, flops, seconds, g, g / self.peak)
        self.entries.append(e)
        return e

    def report(self) -> str:
        lines = [f"{'op':24s} {'GFLOP/s':>12s} {'%peak':>8s} {'time':>10s}"]
        for e in self.entries:
            lines.append(
                f"{e.name:24s} {e.gflops:12.1f} {e.peak_fraction * 100:7.1f}% "
                f"{e.seconds * 1e3:9.2f}ms"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (CPU activity, and CUDA where a card
    is present), written as a Chrome trace ``trace.json`` into ``log_dir``
    on exit; the profiler is yielded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
