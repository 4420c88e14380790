"""Rates of the out-of-core path's layers on the card's host, one panel at a time:

- the host copy a ``DirectPanelStore.pack`` from its RAM cache makes (``np.copyto``,
  one thread), a multi-threaded copy (torch's CPU ``copy_``) and the native
  ``dla_copy2d`` (OpenMP) that ``HostTileStore.pack`` uses;
- ``cudaHostRegister`` of a pool buffer, and host → device copies from a pinned
  buffer, a registered pool buffer and pageable memory;
- the store file's O_DIRECT write and read of one panel;
- the update GEMM at the path's shape, ``gemm(-1, Lk, Lk[:w], 1, P)``, and the
  same product as one in-place ``addmm_``.

    python -m dla_tpu_torch.bench.oocore_probe [--n 131072] [--w 4096]

Prints one line per measurement, the card, the host's memory and cores.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import tempfile
import time

import numpy as np
import torch


def _best(fn, reps=3):
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=131072)
    ap.add_argument("--w", type=int, default=4096)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("oocore_probe: no CUDA device")
    from dla_tpu_torch.ops import gemm
    from dla_tpu_torch.runtime.staging import DirectPanelStore, _aligned_empty, lib

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    with open("/proc/meminfo") as f:
        mem = {ln.split(":")[0]: int(ln.split()[1]) for ln in f}
    print(f"card {card}; host {mem['MemTotal'] / 2**20:.1f} GiB memory "
          f"({mem['MemAvailable'] / 2**20:.1f} available), {os.cpu_count()} cores", flush=True)
    n, w = args.n, args.w
    nbytes = n * w * 4
    gb = nbytes / 1e9

    def rate(name, s, nb=nbytes):
        print(f"{name}: {s * 1e3:.1f} ms for {nb / 2**30:.2f} GiB = {nb / s / 1e9:.2f} GB/s",
              flush=True)

    src = _aligned_empty(nbytes).view(np.float32)
    src[:] = 1.0
    dst = _aligned_empty(nbytes).view(np.float32)
    rate("np.copyto (one thread, DirectPanelStore.pack from its cache)",
         _best(lambda: np.copyto(dst, src)))
    rate("torch CPU copy_ (threads)",
         _best(lambda: torch.from_numpy(dst).copy_(torch.from_numpy(src))))
    rate("native dla_copy2d (OpenMP, HostTileStore.pack)",
         _best(lambda: lib().dla_copy2d_f32(src.ctypes.data, w, dst.ctypes.data, w, n, w)))

    pinned = torch.empty(n * w, dtype=torch.float32, pin_memory=True)
    dev = torch.empty(n * w, dtype=torch.float32, device="cuda")
    rate("h2d from pinned", _best(lambda: dev.copy_(pinned, non_blocking=True)))
    cr = torch.cuda.cudart()
    t0 = time.perf_counter()
    torch.cuda.check_error(cr.cudaHostRegister(dst.ctypes.data, nbytes, 0))
    rate("cudaHostRegister of a pool buffer", time.perf_counter() - t0)
    reg = torch.from_numpy(dst)
    rate("h2d from a registered pool buffer", _best(lambda: dev.copy_(reg, non_blocking=True)))
    torch.cuda.check_error(cr.cudaHostUnregister(dst.ctypes.data))
    rate("h2d from pageable memory", _best(lambda: dev.copy_(torch.from_numpy(src)), reps=1))

    with tempfile.TemporaryDirectory(prefix="dla_oocore_probe_") as tmp:
        with DirectPanelStore(n, np.float32, path=os.path.join(tmp, "p.bin"), panel=w) as st:
            print(f"store file O_DIRECT: {st.direct}", flush=True)
            rate("pwrite of panel 0", _best(
                lambda: st._io(st._lib.dla_pwrite_full, src, 0, "pwrite")))
            rate("pread of panel 0", _best(
                lambda: st._io(st._lib.dla_pread_full, dst, 0, "pread")))

    del dev, pinned
    lk = torch.randn(n, w, device="cuda")
    p = torch.randn(n, w, device="cuda")
    flops = 2.0 * n * w * w
    for name, fn in (("gemm(-1, Lk, Lk[:w], 1, P) (ops.blas)",
                      lambda: gemm(-1.0, lk, lk[:w], 1.0, p, transb=True)),
                     ("P.addmm_(Lk, Lk[:w].T, alpha=-1)",
                      lambda: p.addmm_(lk, lk[:w].mT, alpha=-1.0))):
        s = _best(fn)
        print(f"{name} at {n}x{w}x{w}: {s * 1e3:.1f} ms = {flops / s / 1e12:.2f} TFLOP/s",
              flush=True)
    print(f"per panel at these shapes: {gb:.2f} GB streamed", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
