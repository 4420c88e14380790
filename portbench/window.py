"""The measured window: the one general generator that the traffic mixes
(``traffic/<mix>.json``) parameterize.

``"loop": "back_to_back"``: factorizations one after another, each of the
pristine matrix restaged on the device with its own diagonal shift, the
restage inside the window. The window starts at the first restage and ends
when the first factorization to finish after ``seconds`` has finished, so
it holds whole factorizations only.

``"loop": "closed"``: ``clients`` clients on one host thread and one
stream, each sending its next query when its last one has completed. The
widths come from :func:`portbench.inputs.query_order`. A query's latency
runs from the start of its making (its right-hand sides drawn on the card,
then its submission) to the host seeing it complete
(``torch.cuda.Event.synchronize``). The window ends at the first completion
after ``seconds``; queries still in flight then are drained after it and
count in neither the rate nor the latencies, but their answers may be
sampled.

A ``tracer`` (:class:`portbench.trace.Tracer`) may cut the window into
profiled cycles; between two cycles the device is drained, and the time
spent reading the trace is left out of the window's clock.
"""

from __future__ import annotations

import collections
import time

import torch


def factor_window(sut, seconds: float, tracer=None) -> dict:
    count = 0
    paused = 0.0
    t0 = time.perf_counter()
    if tracer:
        tracer.begin()
    while True:
        count += 1
        sut.restage(count)
        sut.run()
        sut.sync()
        if tracer:
            tracer.unit()
        t = time.perf_counter()
        if t - t0 - paused >= seconds:
            break
        if tracer and tracer.due():
            paused += tracer.cut()
    window_s = t - t0 - paused
    if tracer:
        tracer.end()
    return {"count": count, "window_s": window_s, "kept": {}}


class _Query:
    __slots__ = ("seq", "width", "t_submit", "event", "answer")

    def __init__(self, seq, width, t_submit, event, answer):
        self.seq, self.width, self.t_submit, self.event = seq, width, t_submit, event
        self.answer = answer


def closed_window(sut, traffic: dict, order: list, seconds: float, keep, tracer=None) -> dict:
    """Run the closed loop; ``keep(seq, width)`` says whether a query's answer
    is kept for the check. Returns the counts, the latencies of the queries
    completed in the window and the kept answers {seq: (width, what the
    system's ``submit`` returned)}."""
    inflight: collections.deque = collections.deque()
    lat, widths, kept = [], [], {}
    seq = 0
    card = sut.devices[0].type == "cuda"

    def submit():
        nonlocal seq
        w = order[seq % len(order)]
        t = time.perf_counter()
        answer = sut.submit(w)
        ev = torch.cuda.Event() if card else None
        if ev is not None:
            ev.record()
        inflight.append(_Query(seq, w, t, ev, answer))
        seq += 1

    def complete() -> _Query:
        qr = inflight.popleft()
        if qr.event is not None:
            qr.event.synchronize()
        if keep(qr.seq, qr.width):
            kept[qr.seq] = (qr.width, qr.answer)
        qr.answer = None
        return qr

    paused = 0.0
    t0 = time.perf_counter()
    if tracer:
        tracer.begin()
    for _ in range(traffic["clients"]):
        submit()
    while True:
        qr = complete()
        t = time.perf_counter()
        lat.append(t - qr.t_submit)
        widths.append(qr.width)
        if tracer:
            tracer.unit(qr.width)
        if t - t0 - paused >= seconds:
            break
        if tracer and tracer.due():
            n = len(inflight)
            while inflight:  # a cycle ends with the device drained
                qd = complete()
                lat.append(time.perf_counter() - qd.t_submit)
                widths.append(qd.width)
                tracer.unit(qd.width)
            t = time.perf_counter()
            paused += tracer.cut()
            for _ in range(n):
                submit()
        submit()
    window_s = t - t0 - paused
    if tracer:
        tracer.end()
    while inflight:  # after the window: checked if sampled, never counted
        complete()
    return {"count": len(lat), "window_s": window_s, "latencies_s": lat, "widths": widths,
            "kept": kept, "sent": seq}
