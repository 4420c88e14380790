"""Technical-indicator feature extraction (↔ ``z/chart.py``).

A copy of ``dla_tpu/models/indicators.py``: it is framework-neutral, but
importing anything under ``dla_tpu`` imports jax, which the port never does.

The reference's ``ChartFeature`` computes TA-Lib features per asset
(ROCP / MACD / RSI / BOLL / MA / VMA / PRICE_VOLUME / CROSS_PRICE —
``z/chart.py:30-270``) and a weighted-decay future-return label
(``make_label``, ``z/chart.py:46-57``). TA-Lib is not in this image; the
indicators are implemented directly in numpy (identical formulas), which
also removes the native-library dependency from the feature path.
"""

from __future__ import annotations

import numpy as np

from dla_tpu_torch.models.rawdata import RawData

DEFAULT_SELECTOR = (
    "ROCP",
    "OROCP",
    "HROCP",
    "LROCP",
    "MACD",
    "RSI",
    "VROCP",
    "BOLL",
    "MA",
    "VMA",
    "PRICE_VOLUME",
)


def _ema(x: np.ndarray, span: int) -> np.ndarray:
    alpha = 2.0 / (span + 1.0)
    out = np.empty_like(x, dtype=np.float64)
    out[0] = x[0]
    for i in range(1, len(x)):
        out[i] = alpha * x[i] + (1 - alpha) * out[i - 1]
    return out


def rocp(x: np.ndarray, period: int = 1) -> np.ndarray:
    """Rate of change, percentage: (x_t − x_{t−p}) / x_{t−p}."""
    out = np.zeros_like(x, dtype=np.float64)
    out[period:] = (x[period:] - x[:-period]) / np.where(
        x[:-period] == 0, 1.0, x[:-period]
    )
    return out


def macd(close: np.ndarray, fast: int = 12, slow: int = 26, signal: int = 9):
    """Returns (macd, signal, hist), normalized by price like the reference
    (its MACD features are divided by close to be scale-free)."""
    m = _ema(close, fast) - _ema(close, slow)
    s = _ema(m, signal)
    return m, s, m - s

def rsi(close: np.ndarray, period: int = 14) -> np.ndarray:
    delta = np.diff(close, prepend=close[0])
    gain = np.where(delta > 0, delta, 0.0)
    loss = np.where(delta < 0, -delta, 0.0)
    ag = _ema(gain, 2 * period - 1)  # Wilder smoothing ≈ EMA(2p−1)
    al = _ema(loss, 2 * period - 1)
    rs = ag / np.where(al == 0, 1e-12, al)
    return 100.0 - 100.0 / (1.0 + rs)


def bollinger(close: np.ndarray, period: int = 20, ndev: float = 2.0):
    """Returns %b-style position of price within the bands."""
    ma = np.convolve(close, np.ones(period) / period, mode="full")[: len(close)]
    ma[: period - 1] = close[: period - 1]
    sq = np.convolve(close**2, np.ones(period) / period, mode="full")[: len(close)]
    sq[: period - 1] = close[: period - 1] ** 2
    sd = np.sqrt(np.maximum(sq - ma**2, 1e-12))
    upper, lower = ma + ndev * sd, ma - ndev * sd
    return (close - lower) / np.where(upper == lower, 1.0, upper - lower)


def moving_average_rocp(x: np.ndarray, periods=(5, 10, 20, 30, 60, 90)) -> list[np.ndarray]:
    """Relative distance of price to each MA (the reference's MA features
    are (ma − close)/close)."""
    feats = []
    for p in periods:
        ma = np.convolve(x, np.ones(p) / p, mode="full")[: len(x)]
        ma[: p - 1] = x[: p - 1]
        feats.append((ma - x) / np.where(x == 0, 1.0, x))
    return feats


def extract_features(
    data: RawData, selector=DEFAULT_SELECTOR
) -> tuple[list[str], np.ndarray]:
    """Per-asset feature matrix (F, T). Names returned for panel assembly."""
    c, o, h, l, v = data.close, data.open, data.high, data.low, data.volume
    names: list[str] = []
    rows: list[np.ndarray] = []

    def add(name, arr):
        names.append(name)
        rows.append(np.nan_to_num(arr, nan=0.0, posinf=0.0, neginf=0.0))

    sel = set(selector)
    if "ROCP" in sel:
        add("rocp", rocp(c))
    if "OROCP" in sel:
        add("orocp", rocp(o))
    if "HROCP" in sel:
        add("hrocp", rocp(h))
    if "LROCP" in sel:
        add("lrocp", rocp(l))
    if "MACD" in sel:
        m, s, hist = macd(c)
        add("macd", m / c)
        add("macd_signal", s / c)
        add("macd_hist", hist / c)
    if "RSI" in sel:
        add("rsi", rsi(c) / 100.0 - 0.5)
        add("rsi_rocp", rocp(rsi(c) + 100.0))
    if "VROCP" in sel:
        add("vrocp", np.arctan(rocp(v)))
    if "BOLL" in sel:
        add("boll", bollinger(c) - 0.5)
    if "MA" in sel:
        for p, f in zip((5, 10, 20, 30, 60, 90), moving_average_rocp(c)):
            add(f"ma{p}", f)
    if "VMA" in sel:
        for p, f in zip((5, 10, 20, 30, 60, 90), moving_average_rocp(v)):
            add(f"vma{p}", np.arctan(f))
    if "PRICE_VOLUME" in sel:
        add("price_volume", np.arctan(rocp(c) * rocp(v) * 100.0))
    if "CROSS_PRICE" in sel:
        add("ho", (h - o) / o)
        add("lo", (l - o) / o)
        add("co", (c - o) / o)
    return names, np.stack(rows, axis=0)


def make_label(close: np.ndarray, horizon: int = 5, decay: float = 0.9) -> np.ndarray:
    """Weighted-decay future return (``z/chart.py:46-57``): label_t =
    Σ_{k=1..H} decay^{k-1} · ret_{t+k} / Σ decay^{k-1}, zero-padded at the
    tail."""
    ret = np.zeros_like(close, dtype=np.float64)
    ret[:-1] = close[1:] / close[:-1] - 1.0
    w = decay ** np.arange(horizon)
    w /= w.sum()
    label = np.zeros_like(close, dtype=np.float64)
    for t in range(len(close)):
        hi = min(horizon, len(close) - 1 - t)
        if hi > 0:
            label[t] = (w[:hi] * ret[t : t + hi]).sum() / w[:hi].sum()
    return label


def align_and_merge(
    per_asset: dict[str, tuple[list[str], np.ndarray, list[str]]],
) -> tuple[list[str], list[str], np.ndarray]:
    """Panel assembly over the union of dates with forward-fill
    (``z/chart.py:273-355`` / ``z/feature.py:81-138``).

    per_asset: ticker → (feature_names, (F, T) matrix, dates).
    Returns (tickers, union_dates, panel (A, F, T_union)).
    """
    union: list[str] = sorted({d for _, _, ds in per_asset.values() for d in ds})
    idx = {d: i for i, d in enumerate(union)}
    tickers = sorted(per_asset)
    f = next(iter(per_asset.values()))[1].shape[0]
    panel = np.zeros((len(tickers), f, len(union)), np.float64)
    for a, t in enumerate(tickers):
        _, mat, dates = per_asset[t]
        cols = np.asarray([idx[d] for d in dates])
        panel[a][:, cols] = mat
        # forward-fill gaps (dates an asset didn't trade)
        mask = np.zeros(len(union), bool)
        mask[cols] = True
        last = np.maximum.accumulate(np.where(mask, np.arange(len(union)), -1))
        valid = last >= 0
        panel[a][:, valid] = panel[a][:, last[valid]]
    return tickers, union, panel
