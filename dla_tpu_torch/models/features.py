"""Panel feature pipeline (↔ ``z/feature.py``).

A copy of ``dla_tpu/models/features.py``: it is framework-neutral, but
importing anything under ``dla_tpu`` imports jax, which the port never does.

Builds the training tensors from per-ticker TSVs: per-asset indicator
extraction → union-of-dates panel with forward-fill → sliding windows
X:(N, W, F_total) and multi-asset labels y:(N, M) → per-asset z-score
normalization fit on the *train split only* (``z/feature.py:173-192``) →
two-file dump (features + labels; the reference pickles two files,
``z/feature.py:369-386`` — here a single compressed ``.npz`` carrying both
plus metadata, loadable by the train CLI).
"""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np

from dla_tpu_torch.models.indicators import align_and_merge, extract_features, make_label
from dla_tpu_torch.models.rawdata import read_rawdata_tsv


@dataclasses.dataclass
class FeatureSet:
    x: np.ndarray  # (N, W, F_total)  — windows, time-major per window
    y: np.ndarray  # (N, M)           — per-asset future-return labels
    dates: list[str]  # label date per window
    tickers: list[str]
    feature_names: list[str]
    train_frac: float
    mean: np.ndarray  # (F_total,) train-split normalization
    std: np.ndarray

    @property
    def n_train(self) -> int:
        return int(len(self.x) * self.train_frac)

    def train(self):
        n = self.n_train
        return self.x[:n], self.y[:n]

    def test(self):
        n = self.n_train
        return self.x[n:], self.y[n:]

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            x=self.x.astype(np.float32),
            y=self.y.astype(np.float32),
            dates=np.asarray(self.dates),
            tickers=np.asarray(self.tickers),
            feature_names=np.asarray(self.feature_names),
            train_frac=self.train_frac,
            mean=self.mean,
            std=self.std,
        )

    @classmethod
    def load(cls, path: str) -> "FeatureSet":
        z = np.load(path, allow_pickle=False)
        return cls(
            x=z["x"],
            y=z["y"],
            dates=[str(d) for d in z["dates"]],
            tickers=[str(t) for t in z["tickers"]],
            feature_names=[str(f) for f in z["feature_names"]],
            train_frac=float(z["train_frac"]),
            mean=z["mean"],
            std=z["std"],
        )


def build_features(
    data_dir: str,
    *,
    window: int = 30,
    horizon: int = 5,
    train_frac: float = 0.8,
    tickers: list[str] | None = None,
) -> FeatureSet:
    """End-to-end feature build from a TSV corpus directory."""
    paths = sorted(glob.glob(os.path.join(data_dir, "*.tsv")))
    paths = [p for p in paths if not os.path.basename(p).startswith("_")]
    per_asset = {}
    labels = {}
    names = None
    for p in paths:
        rd = read_rawdata_tsv(p)
        if tickers and rd.ticker not in tickers:
            continue
        names, mat = extract_features(rd)
        per_asset[rd.ticker] = (names, mat, rd.dates)
        labels[rd.ticker] = (make_label(rd.close, horizon=horizon), rd.dates)
    if not per_asset:
        raise FileNotFoundError(f"no ticker TSVs found in {data_dir}")
    tickers_s, union, panel = align_and_merge(per_asset)  # (A, F, T)

    a, f, t = panel.shape
    # labels aligned on the union calendar
    y_panel = np.zeros((a, t), np.float64)
    idx = {d: i for i, d in enumerate(union)}
    for ai, tick in enumerate(tickers_s):
        lab, dates = labels[tick]
        cols = np.asarray([idx[d] for d in dates])
        y_panel[ai][cols] = lab

    # sliding windows: X_t = panel[:, :, t-W+1 .. t], y_t = labels at t
    n = t - window + 1 - horizon  # drop tail windows with padded labels
    if n <= 0:
        raise ValueError("time series shorter than window+horizon")
    feat_total = a * f
    x = np.empty((n, window, feat_total), np.float64)
    y = np.empty((n, a), np.float64)
    flat = panel.reshape(feat_total, t)  # (A*F, T)
    for i in range(n):
        sl = flat[:, i : i + window]  # (A*F, W)
        x[i] = sl.T
        y[i] = y_panel[:, i + window - 1]
    label_dates = union[window - 1 : window - 1 + n]

    # train-only normalization (z/feature.py:173-192)
    n_train = int(n * train_frac)
    mean = x[:n_train].reshape(-1, feat_total).mean(axis=0)
    std = x[:n_train].reshape(-1, feat_total).std(axis=0)
    std = np.where(std < 1e-8, 1.0, std)
    x = (x - mean) / std

    all_names = [f"{tk}:{nm}" for tk in tickers_s for nm in (names or [])]
    return FeatureSet(
        x=x,
        y=y,
        dates=label_dates,
        tickers=tickers_s,
        feature_names=all_names,
        train_frac=train_frac,
        mean=mean,
        std=std,
    )


def audit_overlaps(data_dir: str) -> dict[str, tuple[str, str, int]]:
    """Date-range overlap audit (↔ ``z/audit_overlaps.py``): per ticker
    (start, end, rows); prints the common overlap window."""
    out = {}
    for p in sorted(glob.glob(os.path.join(data_dir, "*.tsv"))):
        if os.path.basename(p).startswith("_"):
            continue
        rd = read_rawdata_tsv(p)
        if len(rd):
            out[rd.ticker] = (rd.dates[0], rd.dates[-1], len(rd))
    return out
