"""Where the time of ``csrc/diag_block.cuh`` goes (kernel #5, #4's diagonal phase).

    python -m dla_tpu_torch.bench.diag_stages_probe [--n 512]

Copies ``diag_block.cuh`` into a temporary directory with ``%globaltimer``
stamps at the phase boundaries of two blocks a launch: block 1 of the
factor stage (the panel block of tile (K+1, K); block 0 in the last stage)
and block 0 of the inverse stage (tile (J, 0)). Builds it with the package's
flags beside a small driver that runs the launches of the schedule one by
one at n (default 512), for fp32 ``highest`` and ``default`` and fp64, and
prints each launch's time by CUDA events and each stamped block's phases:
for the factor, its loads, its two products (its own tile and the diagonal
tile), the diagonal factor, the row solve and the store; for the inverse,
its loads and product, and its column solve. The card's name and power
limit are printed beside them. The stamps cost a few global stores a
launch; the launch times are those of the stamped copy.

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

# (anchor in diag_block.cuh, text put after it)
STAMPS = [
    ("  const int k0 = K * kDB, kp = (K - 1) * kDB;\n  T v[TM][TM];\n", "  FSTAMP(0)\n"),
    ("    if (!diag) load_tile<T, TIER, true, false>(sa, l, n, I * kDB, kp, n, false);\n"
     "    __syncthreads();\n", "    FSTAMP(1)\n"),
    ("    if (!diag) apply<T, false>(v, sa, sb);\n    __syncthreads();\n  }\n", "  FSTAMP(2)\n"),
    ("  factor_diag<T, TIER>(sd, sd + kDB * kDP, nv);  // sd now holds L_KK transposed\n",
     "  FSTAMP(3)\n"),
    ("  solve_rows<T, TIER>(sa, sd, nv);\n  __syncthreads();\n", "  FSTAMP(4)\n"),
    ("  store_tile<false>(l, n, I * kDB, k0, n, sa, false);\n", "  FSTAMP(5)\n"),
    ("  T v[TM][TM];\n  if (J <= C + 1) {", None),
    ("  if (I > J) {\n    regs_store(x, n, I * kDB, C * kDB, n, v);\n    return;\n  }\n",
     "  ISTAMP(1)\n"),
    ("  solve_cols<T, TIER>(sa, sd, min(kDB, n - J * kDB), I == C);\n  __syncthreads();\n",
     "  ISTAMP(2)\n"),
]
HEADER = r'''
__device__ unsigned long long dbg_stamp[2][16][8];
__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define FSTAMP(p) \
  if (threadIdx.x == 0 && b == (diag_tiles(n) - K > 1 ? 1 : 0)) dbg_stamp[0][K][p] = gtimer();
#define ISTAMP(p) if (threadIdx.x == 0 && b == 0) dbg_stamp[1][J][p] = gtimer();
'''
DRIVER = r'''
#include "diag_block.cuh"
template <typename T, int TIER>
int run(const T* a, T* l, T* x, int n, float* ms, unsigned long long* st) {
  constexpr int smem = dla::diag_smem_bytes<T>();
  cudaFuncSetAttribute(dla::diag_stage<T, TIER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const int nt = dla::diag_tiles(n);
  cudaEvent_t ev[18];
  for (int i = 0; i <= nt + 1; ++i) cudaEventCreate(&ev[i]);
  cudaEventRecord(ev[0]);
  for (int t = 0; t <= nt; ++t) {
    dla::diag_stage<T, TIER><<<dla::stage_blocks(nt, t), dla::kDThreads, smem>>>(a, n, l, x, n, t);
    cudaEventRecord(ev[t + 1]);
  }
  cudaEventSynchronize(ev[nt + 1]);
  for (int i = 0; i <= nt; ++i) cudaEventElapsedTime(&ms[i], ev[i], ev[i + 1]);
  for (int i = 0; i <= nt + 1; ++i) cudaEventDestroy(ev[i]);
  cudaMemcpyFromSymbol(st, dla::dbg_stamp, sizeof(unsigned long long) * 2 * 16 * 8);
  return (int)cudaGetLastError();
}
extern "C" int probe_f32(const void* a, void* l, void* x, int n, int tier, float* ms,
                         unsigned long long* st) {
  if (tier == 2) return run<float, dla::kDefault>((const float*)a, (float*)l, (float*)x, n, ms, st);
  return run<float, dla::kHighest>((const float*)a, (float*)l, (float*)x, n, ms, st);
}
extern "C" int probe_f64(const void* a, void* l, void* x, int n, int, float* ms,
                         unsigned long long* st) {
  return run<double, dla::kHighest>((const double*)a, (double*)l, (double*)x, n, ms, st);
}
'''


def _stamped_header(src: str) -> str:
    src = src.replace("namespace dla {\n", "namespace dla {\n" + HEADER, 1)
    for anchor, text in STAMPS:
        if anchor not in src:
            raise RuntimeError(f"diag_stages_probe: diag_block.cuh has changed; no anchor\n{anchor}")
        src = src.replace(anchor, anchor.replace("  T v[TM][TM];\n", "  T v[TM][TM];\n  ISTAMP(0)\n")
                          if text is None else anchor + text, 1)
    return src


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=512)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("diag_stages_probe: no CUDA device", file=sys.stderr)
        return 1
    from dla_tpu_torch.kernels import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    n = args.n
    nt = -(-n // 64)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        (d / "diag_block.cuh").write_text(_stamped_header((_build.CSRC / "diag_block.cuh").read_text()))
        (d / "trailing_block.cuh").write_text((_build.CSRC / "trailing_block.cuh").read_text())
        (d / "probe.cu").write_text(DRIVER)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "probe.so"),
                        str(d / "probe.cu")], check=True)
        lib = ctypes.CDLL(str(d / "probe.so"))
        for sfx, tier, dtype in (("f32", 0, torch.float32), ("f32", 2, torch.float32),
                                 ("f64", 0, torch.float64)):
            fn = getattr(lib, f"probe_{sfx}")
            g = torch.Generator(device="cuda").manual_seed(n)
            x = torch.randn(n, n, generator=g, device="cuda", dtype=torch.float64)
            a = (x @ x.mT + n * torch.eye(n, device="cuda", dtype=torch.float64)).to(dtype)
            l, xi = torch.empty_like(a), torch.empty_like(a)
            ms, st = (ctypes.c_float * 17)(), (ctypes.c_ulonglong * 256)()
            for _ in range(3):  # the last of three runs is printed
                err = fn(ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(l.data_ptr()),
                         ctypes.c_void_p(xi.data_ptr()), n, tier, ms, st)
                if err:
                    raise RuntimeError(f"diag_stages_probe: CUDA error {err}")
            name = f"n={n} {sfx}/{['highest', 'high', 'default'][tier]}"
            print(f"{name}: {nt + 1} launches, {sum(ms[: nt + 1]):.4f} ms: "
                  f"{[round(ms[t], 4) for t in range(nt + 1)]} ms [{card}]")
            us = lambda s, p, q: (s[q] - s[p]) / 1e3  # noqa: E731
            for k in range(nt):
                s = [st[k * 8 + p] for p in range(8)]
                if k == nt - 1 or k == 0:
                    print(f"  factor stage {k}, block {0 if k == nt - 1 else 1}: to the diagonal "
                          f"factor {us(s, 0, 2):.2f} us, diagonal factor {us(s, 2, 3):.2f} us")
                else:
                    print(f"  factor stage {k}, block 1: loads {us(s, 0, 1):.2f} us, products "
                          f"{us(s, 1, 2):.2f}, diagonal factor {us(s, 2, 3):.2f}, row solve "
                          f"{us(s, 3, 4):.2f}, store {us(s, 4, 5):.2f}")
            for j in range(nt):
                s = [st[128 + j * 8 + p] for p in range(8)]
                print(f"  inverse stage {j}, block 0: loads and product {us(s, 0, 1):.2f} us, "
                      f"diagonal tile load and column solve {us(s, 1, 2):.2f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
