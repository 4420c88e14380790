"""Two builds of the ``panel_factor`` kernel held to each other's bits on one GPU.

    python -m dla_tpu_torch.bench.panel_factor_bits --other DIR

``DIR`` holds another version of the kernel sources (``panel_factor.cu`` and
the headers it includes), for example an earlier commit's
``dla_tpu_torch/kernels/csrc`` unpacked with ``git archive`` into a directory
that git ignores. Both versions are compiled with the package's flags and the
C entry ``dla_panel_factor_<dtype>`` of each is launched on the same panels:
m=2048 at nb=512, 192 and 64, for the three fp32 tiers and fp64. Prints, per
case, whether the two outputs (the panel and the inverse scratch) agree bit
for bit and each version's time by CUDA events, with the card's name and
power limit. Exit code 0 when every case agrees.

It needs a CUDA device and ``nvcc`` and fails without them.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch


def _compile(csrc: Path, out: Path):
    from dla_tpu_torch.kernels import _build

    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out),
           str(csrc / "panel_factor.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    fns = {}
    for dtype, suffix in ((torch.float32, "f32"), (torch.float64, "f64")):
        fn = getattr(lib, f"dla_panel_factor_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_int,
                                                                         ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="directory of the other version's sources")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("panel_factor_bits: no CUDA device", file=sys.stderr)
        return 1
    from dla_tpu_torch.kernels import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    m, ok = 2048, True
    with tempfile.TemporaryDirectory() as tmp:
        builds = {"other": _compile(Path(args.other), Path(tmp) / "other.so"),
                  "this": _compile(_build.CSRC, Path(tmp) / "this.so")}
        for nb in (512, 192, 64):
            for dtype, tier in ((torch.float32, 0), (torch.float32, 1), (torch.float32, 2),
                                (torch.float64, 0)):
                g = torch.Generator(device=dev).manual_seed(nb + tier)
                a = torch.randn(m // nb * nb, nb, generator=g, device=dev, dtype=torch.float64)
                a[:nb] = a[:nb] @ a[:nb].mT + nb * torch.eye(nb, device=dev, dtype=torch.float64)
                panel = a.to(dtype)
                outs, ms = {}, {}
                for name, fns in builds.items():
                    out, linv = torch.empty_like(panel), torch.empty(nb, nb, device=dev, dtype=dtype)
                    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    t0.record()
                    err = fns[dtype](panel.data_ptr(), out.data_ptr(), linv.data_ptr(),
                                     panel.shape[0], nb, nb, tier, stream)
                    t1.record()
                    t1.synchronize()
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                    outs[name], ms[name] = (out, linv), t0.elapsed_time(t1)
                view = torch.int32 if dtype == torch.float32 else torch.int64
                same = all(torch.equal(x.view(view), y.view(view))
                           for x, y in zip(outs["other"], outs["this"]))
                ok = ok and same and bool(torch.isfinite(outs["this"][0]).all())
                print(f"panel_factor m={panel.shape[0]} nb={nb} {str(dtype)[6:]} tier {tier}: same "
                      f"bits {same}; other {ms['other']:.3f} ms, this {ms['this']:.3f} ms [{card}]")
    print(f"panel_factor: every case bit-identical: {ok} [{card}]")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
