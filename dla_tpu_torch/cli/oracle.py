"""LAPACK oracle — counterpart of ``dla_tpu/cli/oracle.py``.

The reference's ground-truth programs (``lapacke_dpotrf.c``: plain LAPACKE
``dpotrf`` and the reconstruction residual at a fixed N, under the same 1e-10
gate). This runs scipy's LAPACK ``dpotrf`` on the library's seeded fp64
``plgsy`` (the native host generator, ``HostTileStore.fill_plgsy``, the
device generator's bits) and, with ``--cross-check``, compares the port's
``potrf_blocked`` factor of the same matrix elementwise against it, on the
card unless ``--device cpu``. It prints the main driver's contract lines.

Usage:
    python -m dla_tpu_torch.cli.oracle --n 4096 --nb 256 [--cross-check] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dla-oracle-torch")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--nb", type=int, default=256, help="library NB for --cross-check")
    ap.add_argument("--seed", type=int, default=51)
    ap.add_argument("--cross-check", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where --cross-check runs the port's factorization")
    args = ap.parse_args(argv)

    import numpy as np
    import scipy.linalg

    from dla_tpu_torch.runtime.staging import HostTileStore

    n = args.n
    with HostTileStore(n, np.float64) as st:
        st.fill_plgsy(seed=args.seed)
        a = np.tril(st.array) + np.tril(st.array, -1).T

    t0 = time.perf_counter()
    c, info = scipy.linalg.lapack.dpotrf(a, lower=1)
    t1 = time.perf_counter()
    if info != 0:
        print(f"dpotrf info={info} — FAIL")
        return 1
    l = np.tril(c)
    print(f"Elapsed: {(t1 - t0) * 1e3:.1f} ms")
    print(f"Performance: {(n**3 / 3) / (t1 - t0) / 1e9:.2f} Gflop/s")
    r = a - l @ l.T
    res = np.abs(r).sum(axis=1).max() / np.abs(a).sum(axis=1).max()
    print(f"||A - LL^T||_inf / ||A||_inf = {res:.2e}")
    ok = res < 1e-10
    print("PASS" if ok else "FAIL", "(gate 1e-10)")

    if args.cross_check:
        import torch

        if args.device == "cuda" and not torch.cuda.is_available():
            print("[dla-oracle] --cross-check on cuda: no CUDA device is available; "
                  "use --device cpu", file=sys.stderr)
            return 2
        from dla_tpu_torch.algos import potrf_blocked

        lt = potrf_blocked(torch.from_numpy(a).to(args.device), nb=args.nb).cpu().numpy()
        diff = np.abs(lt - l).max() / np.abs(l).max()
        print(f"max elementwise |L_dla - L_lapack| / max|L| = {diff:.2e}")
        ok = ok and diff < 1e-12
        print("CROSS-CHECK", "PASS" if diff < 1e-12 else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
