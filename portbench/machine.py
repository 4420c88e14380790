"""What the run reads of its machine: when its process started, the cards'
clocks and power, peak device memory, and modules it must not hold."""

from __future__ import annotations

import os
import subprocess
import sys
import time

SMI_FIELDS = "index,name,clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu"
FOREIGN = {"jax", "jaxlib", "flax", "dla_tpu"}


def process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock: now less the
    process's age (``/proc``), or now where that cannot be read."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def smi() -> list:
    """``nvidia-smi``'s reading of every card, one CSV line each, or a line
    saying why there is none."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={SMI_FIELDS}",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return [f"nvidia-smi missing: {type(e).__name__}: {e}"]
    return [line.strip() for line in out.splitlines() if line.strip()]


def peak_memory(devices) -> dict:
    """{card index: the process's peak allocated bytes on it}."""
    import torch

    return {d.index: torch.cuda.max_memory_allocated(d) for d in devices if d.type == "cuda"}


def foreign_modules() -> list:
    """Top-level names in ``sys.modules`` that are JAX's or the JAX package's,
    compared whole (``dla_tpu_torch`` is not ``dla_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FOREIGN)
