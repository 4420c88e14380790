"""Two builds of the ``panel_factor`` kernel held to each other's bits on one GPU.

    python -m dla_tpu_torch.bench.panel_factor_bits --other DIR

``DIR`` holds another version of the kernel sources (``panel_factor.cu`` and
the headers it includes), for example an earlier commit's
``dla_tpu_torch/kernels/csrc`` unpacked with ``git archive`` into a directory
that git ignores. Both versions are compiled with the package's flags and the
C entry ``dla_panel_factor_<dtype>`` of each is launched, through its own C
signature (one that takes a split scratch gets the one
``panel.panel_factor_schedule`` sizes), on the same panels: m=2048 at nb=512,
192 and 64, for the three fp32 tiers and fp64. Prints, per case, whether the
diagonal block and the inverse scratch agree bit for bit, whether the rows
below do, and each version's time by CUDA events, with the card's name and
power limit. Exit code 0 when every case's diagonal block and inverse agree,
and its rows below too where this build runs a chain body (fp32 highest,
fp64: the scalar body's bits); the tensor-core body (fp32 high, default)
sums the rows below in another order.

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
    """Build ``csrc``'s ``panel_factor.cu``: {dtype: (C function, whether it
    takes a split scratch)}."""
    from dla_tpu_torch.bench.kernel_ab import _panel_factor_fn
    from dla_tpu_torch.kernels import _build

    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out),
           str(csrc / "panel_factor.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    return {dtype: _panel_factor_fn(lib, csrc, suffix)
            for dtype, suffix in ((torch.float32, "f32"), (torch.float64, "f64"))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="directory of the other version's sources")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("panel_factor_bits: no CUDA device", file=sys.stderr)
        return 1
    from dla_tpu_torch.kernels import _build, panel

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    m, ok = 2048, True
    with tempfile.TemporaryDirectory() as tmp:
        builds = {"other": _compile(Path(args.other), Path(tmp) / "other.so"),
                  "this": _compile(_build.CSRC, Path(tmp) / "this.so")}
        for nb in (512, 192, 64):
            for dtype, tier, tier_name in ((torch.float32, 0, "highest"),
                                           (torch.float32, 1, "high"),
                                           (torch.float32, 2, "default"),
                                           (torch.float64, 0, "highest")):
                g = torch.Generator(device=dev).manual_seed(nb + tier)
                a = torch.randn(m // nb * nb, nb, generator=g, device=dev, dtype=torch.float64)
                a[:nb] = a[:nb] @ a[:nb].mT + nb * torch.eye(nb, device=dev, dtype=torch.float64)
                p = a.to(dtype)
                rows = p.shape[0]
                sched = panel.panel_factor_schedule(rows, nb, dtype, tier_name)
                buf = panel._split_scratch(sched, dev)
                nbytes = 0 if buf is None else buf.numel() * buf.element_size()
                outs, ms = {}, {}
                for name, fns in builds.items():
                    out, linv = torch.empty_like(p), torch.empty(nb, nb, device=dev, dtype=dtype)
                    fn, scratch = fns[dtype]
                    ptrs = (p.data_ptr(), out.data_ptr(), linv.data_ptr())
                    if scratch:
                        ptrs += (None if buf is None else buf.data_ptr(),)
                    ints = (rows, nb, nb) + ((nbytes,) if scratch else ())
                    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    t0.record()
                    err = fn(*ptrs, *ints, tier, stream)
                    t1.record()
                    t1.synchronize()
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                    outs[name], ms[name] = (out, linv), t0.elapsed_time(t1)
                view = torch.int32 if dtype == torch.float32 else torch.int64
                (x, xi), (y, yi) = outs["other"], outs["this"]
                diag = (torch.equal(x[:nb].view(view), y[:nb].view(view))
                        and torch.equal(xi.view(view), yi.view(view)))
                below = torch.equal(x[nb:].view(view), y[nb:].view(view))
                need_below = sched.body != "wgmma"
                ok = ok and diag and (below or not need_below) and bool(torch.isfinite(y).all())
                print(f"panel_factor m={rows} nb={nb} {str(dtype)[6:]}/{tier_name} (this body "
                      f"{sched.body}): diagonal block and inverse same bits {diag}, rows below "
                      f"same bits {below}{'' if need_below else ' (not required)'}; other "
                      f"{ms['other']:.3f} ms, this {ms['this']:.3f} ms [{card}]")
    print(f"panel_factor: every case as required: {ok} [{card}]")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
