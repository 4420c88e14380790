"""solve_p95_ms: the 95th percentile, nearest rank, of the latency of every
query completed in the window, in ms."""

import math


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile of all ``values``."""
    xs = sorted(values)
    return xs[max(0, math.ceil(q / 100 * len(xs)) - 1)]


def read(run):
    lat = run.window["latencies_s"]
    return percentile(lat, 95) * 1e3 if lat else None
