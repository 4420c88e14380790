"""Where the time of the trailing kernels' paths goes, on one GPU.

    python -m dla_tpu_torch.bench.trailing_paths_probe
        [--paths main,packed,f64x,packed_df64,highest,fp64]

- ``main``: the dense main path, ``potrf_inplace`` of ``plgsy(16384,
  seed=51)`` in fp32 at ``high`` (nb=tb=kb=1024, ib=512, two-level diagonal
  factor: ``chip_smoke.py`` phase 3), kernel #1 15 times;
- ``packed``: the packed path, ``potrf_packed`` of ``plgsy_packed(81920,
  4096, seed=51)`` in fp32 at ``default`` (ktb=1024, kb=4096, ib=512,
  two-level diagonal factor: phase 7), kernel #2 19 times;
- ``f64x``: the f64x path, ``potrf_df64`` of ``plgsy(24576, bump=24576,
  seed=51)`` in fp32 with lo = 0 (nb=1024, s=7, tb=512: phase 11), kernel #9
  23 times;
- ``packed_df64``: the packed df64 path, ``potrf_packed_df64`` of
  ``plgsy_packed(40960, 1024, bump=40960, seed=51)`` with lo = 0 (ktb=512,
  s=7: phase 21), kernel #10 39 times;
- ``highest``: the reference's ``highest`` tier, ``potrf_shrink`` of
  ``plgsy(32768, seed=51)`` in fp32 at ``highest`` (nb=8192, blocktrsm panel,
  tb=1024, kb=256, ``diag_factor="lax"``, ib=512: phase 15),
  kernel #1 3 times on its SIMT body;
- ``fp64``: the native fp64 path, ``potrf_inplace`` of ``plgsy(24576,
  bump=24576, seed=51)`` in fp64 (nb=tb=kb=1024, ib=512, two-level diagonal
  factor: phase 11), kernel #1 23 times on its DMMA body.

Each path is factored once as a warm-up, then once under ``torch.profiler``
(the factorization alone, its input made before): the wall time, the device's
busy and idle share of it and the device time by kernel name (the largest
ten; the trailing kernels are ``trailing_tc_kernel`` and ``split_kernel`` of
``csrc/trailing_wgmma.cuh``, ``trailing_simt_kernel`` and
``trailing_dmma_kernel`` of ``csrc/trailing_chain.cuh``, and
``trailing_df64_tc_kernel`` of ``csrc/trailing_df64.cuh``), then the peak
device memory of a third
factorization timed alone, with the card's name and power limit.

It needs a CUDA device and fails without one.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from dla_tpu_torch.bench.df64_packed_probe import _card
from dla_tpu_torch.bench.ring_planes_probe import device_split

MAIN_KW = dict(nb=1024, tb=1024, kb=1024, ib=512, diag_factor="twolevel", precision="high")
PACKED_KW = dict(diag_factor="twolevel", ib=512, precision="default", trailing="pallas",
                 ktb=1024, kb=4096)
DF64_KW = dict(nb=1024, s=7, trailing="pallas", tb=512)
HIGHEST_KW = dict(nb=8192, panel="blocktrsm", trailing="pallas", tb=1024, kb=256,
                  trailing_alias=False, diag_factor="lax", precision="highest", ib=512)
FP64_KW = dict(nb=1024, tb=1024, kb=1024, ib=512, diag_factor="twolevel")


def _paths(dev):
    import dla_tpu_torch as T
    import dla_tpu_torch.algos as TA

    return {
        "main": ("main path potrf_inplace N=16384 fp32 high",
                 lambda: T.plgsy(16384, seed=51, device=dev),
                 lambda a: TA.potrf_inplace(a, **MAIN_KW)),
        "packed": ("packed path potrf_packed N=81920 w=4096 fp32 default",
                   lambda: TA.plgsy_packed(81920, 4096, seed=51, device=dev),
                   lambda a: T.potrf_packed(a, 81920, 4096, **PACKED_KW)),
        "f64x": ("f64x path potrf_df64 N=24576 nb=1024 s=7",
                 lambda: _pair(T.plgsy(24576, bump=24576.0, seed=51, device=dev)),
                 lambda a: TA.potrf_df64(*a, **DF64_KW)),
        "packed_df64": ("packed df64 path potrf_packed_df64 N=40960 nb=1024 s=7",
                        lambda: _pair(TA.plgsy_packed(40960, 1024, bump=40960.0, seed=51,
                                                      device=dev)),
                        lambda a: TA.potrf_packed_df64(*a, 40960, 1024, ktb=512, s=7)),
        "highest": ("highest tier potrf_shrink N=32768 nb=8192 fp32 highest",
                    lambda: T.plgsy(32768, seed=51, device=dev),
                    lambda a: TA.potrf_shrink(a, **HIGHEST_KW)),
        "fp64": ("native fp64 potrf_inplace N=24576 nb=1024",
                 lambda: T.plgsy(24576, bump=24576.0, seed=51, dtype=torch.float64, device=dev),
                 lambda a: TA.potrf_inplace(a, **FP64_KW)),
    }


def _pair(hi):
    """A df64 pair of an fp32 matrix: (hi, zeros)."""
    return hi, torch.zeros_like(hi)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", default="main,packed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trailing_paths_probe: no CUDA device", file=sys.stderr)
        return 1
    tag = f"[{_card()}]"
    dev = torch.device("cuda")
    paths = _paths(dev)
    for key in args.paths.split(","):
        name, make, factor = paths[key]
        factor(make())  # warm-up: the kernel library, library handles, the allocator
        torch.cuda.synchronize()
        a = make()
        device_split(name, lambda: factor(a), tag)
        del a
        torch.cuda.empty_cache()
        a = make()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        factor(a)
        torch.cuda.synchronize()
        print(f"{name}: {(time.perf_counter() - t0) * 1e3:.1f} ms alone, peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB (the input included) {tag}",
              flush=True)
        del a
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
