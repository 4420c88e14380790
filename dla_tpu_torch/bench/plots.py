"""Plotting layer — counterpart of ``dla_tpu/bench/plots.py``, parity with the
reference's matplotlib scripts, over the CSV of
:mod:`dla_tpu_torch.bench.harness`.

- :func:`plot_perf_grid` ↔ ``plot_grid_all.py``: per-(device-config) grid of
  GFLOP/s-vs-N curves, one line per NB, filtered to ``exit_code == 0``
  (``plot_grid_all.py:39``), **median over timed repeats** (run_idx > 0,
  the compile repeat excluded; the reference medians over repeats at
  ``plot_grid_all.py:45-49``), the card's peak for the panel's precision tier
  as a reference line (not the reference's 243.2/300 CPU/GPU peaks —
  ``plot_grid_all.py:155-156``)
  and a "Best" annotation per panel (``plot_grid_all.py:117-126``).
- :func:`plot_residuals` ↔ ``plot_residuals_per_scheduler.py``: log-scale
  residual-vs-N per config — with mapping names that actually match the CSV
  (the reference's don't: SURVEY Appendix A).

The peaks are the H100 figures of :mod:`dla_tpu_torch.utils.profiling` (an
NVIDIA H100 80GB HBM3 at 700 W: fp32 ``default`` one bf16 pass of the tensor
cores, ``high`` three, ``highest`` IEEE fp32). pandas and matplotlib are
imported inside the functions, so importing this module needs neither.
"""

from __future__ import annotations

import os

from dla_tpu_torch.utils.profiling import device_peak_gflops

DEFAULT_PEAK_GFLOPS = device_peak_gflops("float32", "highest")
PEAK_BY_PRECISION = {p: device_peak_gflops("float32", p)
                     for p in ("default", "high", "highest")}


def load_bench_csv(path):
    """Load one CSV, a comma-separated list, or a sequence of paths
    (campaigns may span schema revisions — e.g. the late-r3 ``kb`` column
    — so frames are concatenated with missing columns left as NaN)."""
    import pandas as pd

    paths = (
        path.split(",") if isinstance(path, str) else list(path)
    )
    df = pd.concat([pd.read_csv(p) for p in paths], ignore_index=True)
    df = df[df["exit_code"] == 0]
    df = df[df["gflops"].notna()]
    return df


def median_over_repeats(df):
    """Median GFLOP/s over timed repeats (run_idx > 0 excludes the
    compile/calibration repeat)."""
    timed = df[df["run_idx"] > 0]
    group_cols = [
        c
        for c in ("mode", "mesh", "dtype", "precision", "kb", "N", "NB")
        if c in timed
    ]
    return (
        # dropna=False: merged frames have NaN kb on pre-kb-column rows —
        # those rows must still aggregate, not silently vanish
        timed.groupby(group_cols, as_index=False, dropna=False)
        .agg(gflops=("gflops", "median"), rel_error=("rel_error", "median"))
    )


def plot_perf_grid(
    csv_path: str,
    out_path: str,
    *,
    peak_gflops: float = DEFAULT_PEAK_GFLOPS,
):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    df = median_over_repeats(load_bench_csv(csv_path))
    if "precision" not in df:
        df = df.assign(precision="highest")
    if "device" not in df:
        df = df.assign(device="cuda")
    configs = sorted(
        df.groupby(["mode", "mesh", "dtype", "precision", "device"]).groups
    )
    ncols = max(1, len(configs))
    fig, axes = plt.subplots(1, ncols, figsize=(6 * ncols, 4.5), squeeze=False)
    for ax, key in zip(axes[0], configs):
        mode, mesh, dtype, prec, device = key
        sub = df[
            (df["mode"] == mode) & (df["mesh"] == mesh)
            & (df["dtype"] == dtype) & (df["precision"] == prec)
            & (df["device"] == device)
        ]
        # peak-fraction annotations only make sense on the card; CPU panels
        # get none
        peak = (
            PEAK_BY_PRECISION.get(str(prec), peak_gflops)
            if device != "cpu" else None
        )
        for nb, g in sub.groupby("NB"):
            g = g.sort_values("N")
            ax.plot(g["N"], g["gflops"], marker="o", label=f"NB={nb}")
        if len(sub):
            best = sub.loc[sub["gflops"].idxmax()]
            frac = f" = {best['gflops'] / peak:.0%} of peak" if peak else ""
            ax.annotate(
                f"Best: {best['gflops']:.0f} GF/s{frac}\n"
                f"(N={best['N']}, NB={best['NB']})",
                xy=(best["N"], best["gflops"]),
                xytext=(0.45, 0.15),
                textcoords="axes fraction",
                arrowprops={"arrowstyle": "->"},
            )
        if peak:
            ax.axhline(peak, ls="--", c="gray", lw=1,
                       label=f"H100 peak ({prec})")
        ax.set_title(f"{mode} {mesh} {dtype} {prec} [{device}]")
        ax.set_xlabel("N")
        ax.set_ylabel("GFLOP/s")
        ax.legend(fontsize=7)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_serving(
    jsonl_paths,
    out_path: str,
    *,
    ceiling_gflops: float = PEAK_BY_PRECISION["high"],
):
    """Serving characterization figure from solve-path jsonl rows (``path``,
    ``n``, ``nrhs``, ``ib``, ``rhs_cols_per_s``, ``gflops``): RHS columns/s
    and GF/s vs the RHS block width, one series per (path, N), with the
    card's ``high``-tier peak for scale. The reference has no solve-path
    plot to mirror — this follows the perf-grid house style."""
    import json as _json

    import matplotlib
    import pandas as pd

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = []
    for p in jsonl_paths:
        with open(p) as f:
            for line in f:
                line = line.strip()
                if line:
                    rows.append(_json.loads(line))
    df = pd.DataFrame(rows)
    if "path" not in df:
        df = df.assign(path="potrs")
    df["path"] = df["path"].fillna("potrs")
    # the latency probe sweeps ib for potrs; keep the shipping default
    if "ib" in df:
        df = df[(df["path"] != "potrs") | df["ib"].isna()
                | (df["ib"] == 512)]
    df = (
        df.groupby(["path", "n", "nrhs"], as_index=False)
        .agg({"rhs_cols_per_s": "max", "gflops": "max"})
    )
    fig, axes = plt.subplots(1, 2, figsize=(11, 4.5))
    for (path, n), g in df.groupby(["path", "n"]):
        g = g.sort_values("nrhs")
        for ax, col in zip(axes, ("rhs_cols_per_s", "gflops")):
            ax.plot(g["nrhs"], g[col], marker="o", label=f"{path} N={n}")
    axes[1].axhline(ceiling_gflops, ls="--", c="gray", lw=1,
                    label="high-tier peak")
    for ax, ylab in zip(axes, ("RHS columns/s", "GFLOP/s (2·N²·NRHS)")):
        ax.set_xscale("log", base=2)
        ax.set_xlabel("NRHS (RHS block width)")
        ax.set_ylabel(ylab)
        ax.legend(fontsize=7)
    axes[0].set_title("serving throughput from a resident factor")
    axes[1].set_title("solve rate vs the card's high-tier peak")
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_residuals(csv_path: str, out_path: str):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    df = load_bench_csv(csv_path)
    df = df[df["rel_error"].notna() & (df["run_idx"] > 0)]
    configs = sorted(df.groupby(["mode", "dtype"]).groups)
    ncols = max(1, len(configs))
    fig, axes = plt.subplots(1, ncols, figsize=(5 * ncols, 4), squeeze=False)
    for ax, key in zip(axes[0], configs):
        mode, dtype = key
        sub = df[(df["mode"] == mode) & (df["dtype"] == dtype)]
        for nb, g in sub.groupby("NB"):
            med = g.groupby("N", as_index=False)["rel_error"].median()
            ax.semilogy(med["N"], med["rel_error"], marker="s", label=f"NB={nb}")
        ax.axhline(1e-10, ls=":", c="red", lw=1, label="1e-10 gate")
        ax.set_title(f"residual — {mode} {dtype}")
        ax.set_xlabel("N")
        ax.set_ylabel("||A-LL^T||/||A||")
        ax.legend(fontsize=7)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="dla-bench-plots-torch")
    ap.add_argument("csv", nargs="+",
                    help="one or more bench CSVs (merged for plotting)")
    ap.add_argument("--out-dir", required=True, help="where the PNGs go")
    ap.add_argument("--peak", type=float, default=DEFAULT_PEAK_GFLOPS)
    args = ap.parse_args(argv)
    p1 = plot_perf_grid(
        args.csv, os.path.join(args.out_dir, "perf_grid.png"), peak_gflops=args.peak
    )
    p2 = plot_residuals(args.csv, os.path.join(args.out_dir, "residuals.png"))
    print(p1)
    print(p2)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
