"""Two builds of the dense df64 trailing kernel side by side on one GPU.

    python -m dla_tpu_torch.bench.df64_kernel_ab --other DIR [--m 24576] [--iters 3]

``DIR`` holds another version of the kernel sources (``trailing_df64.cu`` and
the headers it includes), for example an earlier commit's
``dla_tpu_torch/kernels/csrc`` unpacked with ``git archive`` into a directory
that git ignores. Both versions are compiled with the package's flags (plus
``-Xptxas -v``, whose register and shared-memory counts are printed), and the
C entry ``dla_trailing_df64`` of each is launched on the same pair and slices
at the f64x path's shape (tb=512, nb=1024, s=7, w=8, origin 0), in turns:
other, this, this, other. Prints each launch's time by CUDA events, whether
the two give the same bits, and the card's name and power limit. Two versions
are only comparable inside one such call.

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

    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(out),
           str(csrc / "trailing_df64.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stderr}")
    for line in proc.stderr.splitlines():
        if "registers" in line or "stack frame" in line:
            print(f"  {csrc}: {line.strip()}")
    fn = ctypes.CDLL(str(out)).dla_trailing_df64
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
                   + [ctypes.c_longlong] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="directory of the other version's sources")
    ap.add_argument("--m", type=int, default=24576)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("df64_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    from dla_tpu_torch.kernels import _build
    from dla_tpu_torch.ops.df64 import slice_rows, to_df64

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    m, tb, nb, s = args.m, 512, 1024, 7
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(m)
    ch, cl = to_df64(torch.randn(m, m, generator=g, device=dev, dtype=torch.float64))
    sx = slice_rows(*to_df64(torch.randn(m, nb, generator=g, device=dev, dtype=torch.float64)),
                    s=s, w=8)[0]
    ptrs = (ctypes.c_void_p * s)(*[x.data_ptr() for x in sx])
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        fns = {"other": _compile(Path(args.other), Path(tmp) / "other.so"),
               "this": _compile(_build.CSRC, Path(tmp) / "this.so")}
        outs, times = {}, {"other": [], "this": []}
        for name in ["other", "this", "this", "other"] * args.iters:
            h, l = ch.clone(), cl.clone()
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            err = fns[name](h.data_ptr(), l.data_ptr(), ptrs, m, nb, m, nb, 0, tb, nb, s, 3, stream)
            t1.record()
            t1.synchronize()
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            times[name].append(t0.elapsed_time(t1))
            outs[name] = (h, l)
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(outs["other"], outs["this"]))
    for name, ts in times.items():
        print(f"{name}: first launch {ts[0]:.3f} ms, then median {sorted(ts[1:])[len(ts[1:]) // 2]:.3f} "
              f"ms of {[round(t, 3) for t in ts[1:]]} [{card}]")
    print(f"m={m} tb={tb} nb={nb} s={s}: same bits {same} [{card}]")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
