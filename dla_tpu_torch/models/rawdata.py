"""OHLCV raw data container + robust TSV IO (↔ ``z/rawdata.py``).

A copy of ``dla_tpu/models/rawdata.py``: it is framework-neutral, but
importing anything under ``dla_tpu`` imports jax, which the port never does.

TSV schema (one file per ticker): date, open, high, low, close, volume —
tab-separated, ISO dates, header optional, blank/malformed lines skipped
(the reference's reader is similarly defensive, ``z/rawdata.py:19-78``).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class RawData:
    ticker: str
    dates: list[str]
    open: np.ndarray
    high: np.ndarray
    low: np.ndarray
    close: np.ndarray
    volume: np.ndarray

    def __len__(self) -> int:
        return len(self.dates)


_COLS = ("date", "open", "high", "low", "close", "volume")


def write_rawdata_tsv(path: str, data: RawData) -> None:
    with open(path, "w") as f:
        f.write("\t".join(_COLS) + "\n")
        for i, d in enumerate(data.dates):
            f.write(
                f"{d}\t{data.open[i]:.6f}\t{data.high[i]:.6f}\t"
                f"{data.low[i]:.6f}\t{data.close[i]:.6f}\t{data.volume[i]:.1f}\n"
            )


def read_rawdata_tsv(path: str, ticker: str | None = None) -> RawData:
    """Robust TSV reader: skips header/blank/short/unparseable rows."""
    if ticker is None:
        ticker = os.path.splitext(os.path.basename(path))[0]
    dates: list[str] = []
    cols: list[list[float]] = [[] for _ in range(5)]
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 6:
                continue
            try:
                vals = [float(p) for p in parts[1:6]]
            except ValueError:
                continue  # header or malformed row
            dates.append(parts[0])
            for c, v in zip(cols, vals):
                c.append(v)
    o, h, l, c, v = (np.asarray(x, np.float64) for x in cols)
    return RawData(ticker, dates, o, h, l, c, v)


# legacy alias kept for interface parity (``z/rawdata.py:88-90``)
read_sample_data = read_rawdata_tsv
