"""The traced run: ``torch.profiler`` over the window, cut into cycles, and
the reduction of its events to what the per-layer readers read.

The profiler records device activity (kernels, copies, fills, on every card
of the cell) and the host's CUDA runtime and driver calls; no CPU operator
events, whose cost would slow the host-paced paths it measures. The window
is cut into cycles of about ``cycle_s`` seconds at the end of a unit of work
(a factorization, or a query with the device drained), so that no cycle
overflows the profiler's buffers. Each cycle is reduced as soon as it ends
and the time that takes is left out of the window.

A cycle's window runs from its first recorded event to its last. A device
is busy where any of its operations runs (the union of their intervals);
the traced window's busy time per device is the sum over the cycles. An
idle gap of a device is named by the host call that overlaps it most, or
``host outside CUDA calls`` where calls cover less than half of it.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import heapq
import time

OUTSIDE = "host outside CUDA calls"
TOP = 10


@dataclasses.dataclass
class Summary:
    """The traced window, reduced: its length, each device's busy time, the
    device time and count of each (device, operation name), the count of
    each host call, the longest idle gaps, and the units of work completed
    with the widths of the queries among them."""

    devices: list
    window_ns: int = 0
    busy_ns: dict = dataclasses.field(default_factory=dict)
    ops: dict = dataclasses.field(default_factory=dict)
    calls: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    gaps: list = dataclasses.field(default_factory=list)  # heap of (ns, name)
    units: int = 0
    widths: list = dataclasses.field(default_factory=list)
    cycles: int = 0
    kinds: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    def busy_s(self) -> float:
        """Busy seconds, averaged over the cell's devices."""
        return sum(self.busy_ns.get(d, 0) for d in self.devices) / len(self.devices) / 1e9

    def idle_share(self) -> float | None:
        """The mean over the devices of each one's idle share of the window."""
        if not self.window_ns:
            return None
        return 1.0 - self.busy_s() * 1e9 / self.window_ns

    def op_ns(self, patterns) -> int:
        """Device time of the operations whose names match any of ``patterns``,
        summed over the devices."""
        return sum(ns for (_, name), (ns, _) in self.ops.items()
                   if any(p.search(name) for p in patterns))

    def call_count(self, patterns) -> int:
        return sum(c for name, c in self.calls.items() if any(p.search(name) for p in patterns))

    def breakdown(self) -> dict:
        by_name: collections.Counter = collections.Counter()
        for (_, name), (ns, _) in self.ops.items():
            by_name[name] += ns
        return {
            "device_ops": [[_short(n), ns / 1e9] for n, ns in by_name.most_common(TOP)],
            "idle_gaps": [[name, ns / 1e9] for ns, name in sorted(self.gaps, reverse=True)],
        }


def _short(name: str, width: int = 160) -> str:
    return name if len(name) <= width else name[: width - 3] + "..."


def _merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _name_gap(s: int, e: int, host, starts) -> str:
    """The host call overlapping [s, e) the most (``host`` sorted by start,
    ``starts`` their starts), or :data:`OUTSIDE`."""
    best, best_ov, total = None, 0, 0
    i = max(0, bisect.bisect_right(starts, s) - 64)
    while i < len(host) and host[i][0] < e:
        hs, he, name = host[i]
        ov = min(he, e) - max(hs, s)
        if ov > 0:
            total += ov
            if ov > best_ov:
                best, best_ov = name, ov
        i += 1
    return best if best is not None and 2 * total >= (e - s) else OUTSIDE


def reduce_cycle(events, summary: Summary) -> None:
    """Fold one cycle's events, (kind, name, device, start_ns, end_ns) with
    kind ``device`` or ``host``, into ``summary``."""
    dev = collections.defaultdict(list)
    host = []
    lo, hi = None, None
    for kind, name, d, s, e in events:
        lo = s if lo is None or s < lo else lo
        hi = e if hi is None or e > hi else hi
        if kind == "device":
            dev[d].append((s, e))
            acc = summary.ops.setdefault((d, name), [0, 0])
            acc[0] += e - s
            acc[1] += 1
        else:
            host.append((s, e, name))
            summary.calls[name] += 1
    if lo is None:
        return
    summary.cycles += 1
    summary.window_ns += hi - lo
    host.sort()
    starts = [h[0] for h in host]
    multi = len(summary.devices) > 1
    for d in summary.devices:
        merged = _merge(dev.get(d, ()))
        summary.busy_ns[d] = summary.busy_ns.get(d, 0) + sum(e - s for s, e in merged)
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
                for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        for ns, s, e in heapq.nlargest(TOP, gaps):
            name = _name_gap(s, e, host, starts) + (f" (cuda:{d})" if multi else "")
            if len(summary.gaps) < TOP:
                heapq.heappush(summary.gaps, (ns, name))
            elif ns > summary.gaps[0][0]:
                heapq.heapreplace(summary.gaps, (ns, name))


def _ns(ev, what: str) -> int:
    """An event's start or duration in ns (``start_ns`` where the profiler
    has it, else ``start_us``)."""
    get = getattr(ev, f"{what}_ns", None)
    return int(get()) if get is not None else int(getattr(ev, f"{what}_us")() * 1000)


def kineto_events(result, summary: Summary):
    """The events of a profiler result as (kind, name, device, start, end):
    ``device`` for an operation on a card (kernel, copy, fill), ``host`` for
    a CUDA runtime or driver call; each kind's count in ``summary.kinds``.
    With only CUDA activity recorded, every host event is such a call."""
    from torch.autograd import DeviceType

    for ev in result.events():
        name = ev.name()
        annotation = getattr(ev, "is_user_annotation", None)
        if annotation is not None and annotation():
            summary.kinds["annotation"] += 1
            continue
        s = _ns(ev, "start")
        if ev.device_type() == DeviceType.CUDA:
            summary.kinds["device"] += 1
            yield "device", name, ev.device_index(), s, s + _ns(ev, "duration")
        elif name.startswith("cu"):
            summary.kinds["host"] += 1
            yield "host", name, -1, s, s + _ns(ev, "duration")
        else:
            summary.kinds["other"] += 1


class Tracer:
    """Profiles the window in cycles over the CUDA devices ``devices``
    (indices) and reduces each cycle into :attr:`summary`."""

    def __init__(self, devices, cycle_s: float = 2.0):
        self.summary = Summary(devices=list(devices))
        self.cycle_s = cycle_s
        self._prof = None
        self._t = 0.0

    def _start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._t = time.perf_counter()

    def _stop(self) -> None:
        self._prof.stop()
        reduce_cycle(kineto_events(self._prof.profiler.kineto_results, self.summary),
                     self.summary)
        self._prof = None

    def warm(self) -> None:
        """Start and stop the profiler once, unrecorded: its start-up (CUPTI's)
        belongs to set-up, not to the first cycle."""
        self._start()
        self._prof.stop()
        self._prof = None

    def begin(self) -> None:
        self._start()

    def unit(self, width: int | None = None) -> None:
        self.summary.units += 1
        if width is not None:
            self.summary.widths.append(width)

    def due(self) -> bool:
        return time.perf_counter() - self._t >= self.cycle_s

    def cut(self) -> float:
        """End this cycle and start the next; the seconds it took."""
        t = time.perf_counter()
        self._stop()
        self._start()
        return time.perf_counter() - t

    def end(self) -> None:
        self._stop()
