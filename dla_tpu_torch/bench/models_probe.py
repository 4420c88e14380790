"""Where the finance model's time goes, on one GPU.

    python -m dla_tpu_torch.bench.models_probe [--steps 40] [--batch 64]

At the JAX package's CLI defaults (T=30, 456 inputs = 19 tickers × 24
features, hidden 64 32, 19 outputs, the CLI's noise 0.05 and dropout 0.1;
inputs and weights from seed 39):

- what each CLI process pays before its work: the wall time of ``python -c``
  with ``import torch``, with ``import dla_tpu_torch.models.cli``, and with
  that import plus the card's first tensor;
- the Adam step: host ms a step between two synchronizations, its forward,
  backward and optimizer parts (CUDA events), then one ``torch.profiler``
  pass over ten steps: the device's busy and idle share, kernel launches a
  step and the largest kernels;
- ``predict`` at batch 256: rows a second;

with the card's name and power limit. It needs a CUDA device and fails
without one.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

from dla_tpu_torch.bench.df64_packed_probe import _card
from dla_tpu_torch.bench.ring_planes_probe import device_split

T, F, HIDDEN, OUTPUTS = 30, 19 * 24, (64, 32), 19
STARTS = (
    ("import torch", "import torch"),
    ("import dla_tpu_torch.models.cli", "import dla_tpu_torch.models.cli"),
    ("the same + the card's first tensor", "import dla_tpu_torch.models.cli, torch; "
     "torch.zeros(1, device='cuda'); torch.cuda.synchronize()"),
)


def process_starts(tag: str) -> None:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for name, code in STARTS:
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=300)
        print(f"process start, {name}: {time.perf_counter() - t0:.2f} s {tag}", flush=True)


def main(argv=None) -> int:
    from dla_tpu_torch.models.windpuller import WindPuller, risk_estimation

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("models_probe: no CUDA device", file=sys.stderr)
        return 1
    tag = f"[{_card()}]"
    process_starts(tag)

    rng = np.random.default_rng(39)
    x = rng.standard_normal((args.batch, T, F)).astype(np.float32)
    y = (0.02 * rng.standard_normal((args.batch, OUTPUTS))).astype(np.float32)
    wp = WindPuller(input_shape=(T, F), outputs=OUTPUTS, hidden=HIDDEN, seed=39)
    xb, yb = wp._tensor(x), wp._tensor(y)
    gen = torch.Generator(device=wp.device).manual_seed(40)
    for _ in range(3):  # warm-up: library handles, the allocator
        wp._step(xb, yb, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        wp._step(xb, yb, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / args.steps * 1e3
    nparams = sum(p.numel() for p in wp.net.parameters())
    print(f"Adam step, batch {args.batch}, T={T}, F={F}, hidden {HIDDEN}, {nparams} parameters: "
          f"{step_ms:.3f} ms a step (host clock, {args.steps} steps) {tag}", flush=True)

    parts = np.zeros(3)
    for _ in range(args.steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        wp.net.train()
        ev[0].record()
        loss = risk_estimation(yb, wp.net(xb, gen))
        ev[1].record()
        wp.opt.zero_grad(set_to_none=True)
        loss.backward()
        ev[2].record()
        wp.opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        parts += [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    parts /= args.steps
    print(f"Adam step parts (CUDA events): forward {parts[0]:.3f} ms, backward {parts[1]:.3f} ms, "
          f"optimizer {parts[2]:.3f} ms {tag}", flush=True)

    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            wp._step(xb, yb, gen)
        torch.cuda.synchronize()
    launches = sum(ev.device_type == torch.autograd.DeviceType.CUDA for ev in prof.events())
    print(f"kernel launches a step: {launches / 10:.0f} {tag}", flush=True)
    device_split("ten Adam steps", lambda: [wp._step(xb, yb, gen) for _ in range(10)], tag)

    xp = rng.standard_normal((1226, T, F)).astype(np.float32)  # every window of the corpus
    wp.predict(xp)
    t0 = time.perf_counter()
    for _ in range(5):
        wp.predict(xp)
    dt = (time.perf_counter() - t0) / 5
    print(f"predict, {len(xp)} windows at batch 256: {dt * 1e3:.1f} ms, {len(xp) / dt:.0f} "
          f"rows/s {tag}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
