"""Device activity from torch.profiler over a steady slice of the window,
with a check that the trace is whole.

The tracer (kineto over CUPTI) can lose device records at either end of a
session. So the session opens on a few marker kernels, a synchronize and
a pause, and closes after a synchronize and a pause; only the launches
between the opening pause and the closing synchronize count, and each is
matched with its device record by correlation id. A session that lost
more than LOST_SHARE of them gives no metric (`Trace.lost`).

The server keeps serving through the session, and the load keeps coming:
both run on threads of their own.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch

MARKERS = 4
MARKER_CYCLES = 1000
PAUSE_S = 0.02
LOST_SHARE = 1e-3


@dataclass
class Trace:
    ns0: int  # the slice: after the opening pause ...
    ns1: int  # ... to the closing synchronize
    kernels: List[Tuple[str, int, int]] = field(default_factory=list)
    launches: int = 0
    lost: int = 0

    @property
    def window_s(self) -> float:
        return (self.ns1 - self.ns0) * 1e-9

    def busy(self) -> List[Tuple[int, int]]:
        """The union of device activity, clipped to the slice."""
        iv = sorted((max(s, self.ns0), min(e, self.ns1))
                    for _, s, e in self.kernels)
        out: List[List[int]] = []
        for s, e in iv:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-9

    def gaps(self) -> List[Tuple[int, int]]:
        """Idle intervals of the slice."""
        out, t = [], self.ns0
        for s, e in self.busy():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.ns1 > t:
            out.append((t, self.ns1))
        return out

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def ok(self) -> bool:
        return self.launches > 0 and self.lost <= LOST_SHARE * self.launches


def warm() -> None:
    """One short session, so that the tracer's first attach to the card
    happens in set-up and not inside the window."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()


def session(start: float, stop: float) -> Trace:
    """Profile the card from perf_counter time `start` to `stop`, on the
    calling thread (the tracer runs on the thread that loaded it), while
    other threads serve and load."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    time.sleep(max(start - time.perf_counter(), 0.0))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(MARKERS):
            torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
        time.sleep(PAUSE_S)
        ns0 = time.time_ns()
        time.sleep(max(stop - time.perf_counter(), 0.0))
        torch.cuda.synchronize()
        ns1 = time.time_ns()
        time.sleep(PAUSE_S)
    events = prof.profiler.kineto_results.events()
    trace = Trace(ns0, ns1)
    recorded = set()
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            recorded.add(e.correlation_id())
            s = e.start_ns()
            if s + e.duration_ns() > ns0 and s < ns1:
                trace.kernels.append((e.name(), s, s + e.duration_ns()))
    calls = [e.correlation_id() for e in events
             if e.device_type() == DeviceType.CPU
             and "aunch" in e.name() and ns0 <= e.start_ns() < ns1]
    trace.launches = len(calls)
    trace.lost = sum(1 for c in calls if c not in recorded)
    return trace


def whole_session(first: float, last: float, span: float, log
                  ) -> Optional[Trace]:
    """Sessions of `span` seconds one after another from perf_counter time
    `first`, until one keeps every device record (-> it) or the next would
    end after `last` (-> None); each one that lost records is logged."""
    start = first
    while start + span <= last:
        tr = session(start, start + span)
        if tr.ok():
            return tr
        log(f"profiler session lost {tr.lost} of {tr.launches} device "
            f"records: profiled again")
        start = time.perf_counter() + 1.0
    return None


def inside(kernels, spans) -> List[Tuple[str, int, int]]:
    """The kernels whose device interval lies within one of the spans
    [(ns0, ns1)]: a span ends in a host synchronize, so the work it
    launched is done inside it."""
    spans = sorted(spans)
    out = []
    for k in kernels:
        for s0, s1 in spans:
            if k[1] >= s0 and k[2] <= s1:
                out.append(k)
                break
    return out
