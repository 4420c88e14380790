"""Dataset producer (↔ ``z/generate_dataset.py``).

The reference downloads OHLCV via yfinance per ticker universe
(indices / bluechips / sectors / etf — ``z/generate_dataset.py:48-97``) and
writes one TSV per ticker plus a ``_meta_universe.tsv``. This environment has
zero egress, so the producer here synthesizes seeded correlated
geometric-Brownian-motion OHLCV series with realistic volume — the pipeline
capability (a TSV corpus + universe metadata driving the feature/model
stack) is identical, and real data drops in via the same TSV schema.

A copy of ``dla_tpu/models/synthetic.py`` with one repair. The JAX package
seeds each ticker with ``hash((ticker, seed))``, and Python salts ``str``
hashes per process (``PYTHONHASHSEED``), so its ``--seed`` gives another
corpus in every process. Here the per-ticker seed is a CRC-32 of the ticker
and the seed (:func:`ticker_seed`), the same in every process. The GBM body
and the TSV schema are the JAX package's.
"""

from __future__ import annotations

import datetime as _dt
import os
import zlib

import numpy as np

from dla_tpu_torch.models.rawdata import RawData, write_rawdata_tsv

UNIVERSES: dict[str, list[str]] = {
    "indices": ["SPX", "NDX", "DJI", "RUT"],
    "bluechips": ["AAA", "BBB", "CCC", "DDD", "EEE"],
    "sectors": ["XLE", "XLF", "XLK", "XLV"],
    "etf": ["AGG", "GLD", "USO", "VNQ", "EEM", "EFA"],
}


def ticker_seed(ticker: str, seed: int) -> int:
    """The per-ticker generator seed: stable across processes, in [0, 2**32)."""
    return zlib.crc32(f"{ticker}\0{seed}".encode())


def synth_ohlcv(
    ticker: str,
    days: int = 2520,
    *,
    seed: int = 0,
    start: str = "2015-01-02",
    s0: float = 100.0,
    mu: float = 0.06,
    sigma: float = 0.2,
) -> RawData:
    """Seeded GBM daily bars with intraday range and log-normal volume."""
    rng = np.random.default_rng(ticker_seed(ticker, seed))
    dt = 1.0 / 252.0
    z = rng.standard_normal(days)
    logret = (mu - 0.5 * sigma**2) * dt + sigma * np.sqrt(dt) * z
    close = s0 * np.exp(np.cumsum(logret))
    open_ = np.concatenate([[s0], close[:-1]]) * np.exp(
        rng.standard_normal(days) * sigma * np.sqrt(dt) * 0.3
    )
    hi_span = np.abs(rng.standard_normal(days)) * sigma * np.sqrt(dt)
    lo_span = np.abs(rng.standard_normal(days)) * sigma * np.sqrt(dt)
    high = np.maximum(open_, close) * np.exp(hi_span)
    low = np.minimum(open_, close) * np.exp(-lo_span)
    volume = np.exp(rng.standard_normal(days) * 0.5 + 13.0)
    d0 = _dt.date.fromisoformat(start)
    dates, d = [], d0
    while len(dates) < days:
        if d.weekday() < 5:
            dates.append(d.isoformat())
        d += _dt.timedelta(days=1)
    return RawData(ticker, dates, open_, high, low, close, volume)


def generate_dataset(
    out_dir: str,
    universes: list[str] | None = None,
    *,
    days: int = 2520,
    seed: int = 0,
) -> list[str]:
    """Write one TSV per ticker + ``_meta_universe.tsv``; returns tickers."""
    os.makedirs(out_dir, exist_ok=True)
    universes = universes or list(UNIVERSES)
    tickers: list[str] = []
    meta_rows = []
    for u in universes:
        for t in UNIVERSES[u]:
            data = synth_ohlcv(t, days, seed=seed)
            write_rawdata_tsv(os.path.join(out_dir, f"{t}.tsv"), data)
            tickers.append(t)
            meta_rows.append((t, u, data.dates[0], data.dates[-1], len(data)))
    with open(os.path.join(out_dir, "_meta_universe.tsv"), "w") as f:
        f.write("ticker\tuniverse\tstart\tend\trows\n")
        for r in meta_rows:
            f.write("\t".join(map(str, r)) + "\n")
    return tickers
