"""The device timeline of a traced segment, from ``torch.profiler``.

``busy(fn)`` runs ``fn`` under a profiler that records device activity
alone and returns its device-busy seconds and the length of its window:
with no operator or span events to record on the host, the profiler adds
little to each launch, so a host-paced unit runs at nearly its untraced
pace and its idle share is not overstated.

``record(fn)`` runs ``fn`` under the profiler (CPU and CUDA activity) inside
a ``record_function("traced_window")`` range and reduces the events to:

* ``kernels``: every device operation (kernels, copies, sets) as (name,
  start, end, launch), times in ns on the host's clock; ``launch`` is the
  host time of the runtime call that issued it (matched by correlation id);
* ``spans``: the benchmark's ``record_function`` ranges, (name, start, end);
* ``host``: the other host-side events (operators, runtime calls); the
device operations whose launch it does not find are left out and named in
``unmatched``.

The readers in ``benchmark/metrics`` take their numbers from a ``Trace``.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

WINDOW = "traced_window"


def is_collective(name: str) -> bool:
    """Whether a device operation is a collective's kernel (NCCL names its
    kernels ``ncclKernel_*`` or ``ncclDevKernel_*``)."""
    return name.startswith("nccl")


@dataclass
class Trace:
    kernels: list = field(default_factory=list)  # (name, start, end, launch)
    spans: list = field(default_factory=list)  # (name, start, end)
    host: list = field(default_factory=list)  # (name, start, end)
    start: int = 0
    end: int = 0
    unmatched: list = field(default_factory=list)  # device operations with no launch found

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-9

    def busy_intervals(self) -> list:
        """Merged device-busy intervals inside the window."""
        out = []
        for _, s, e, _ in sorted(self.kernels, key=lambda k: k[1]):
            s, e = max(s, self.start), min(e, self.end)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def under(self, name: str) -> list:
        """The device operations launched inside a span called ``name``."""
        ranges = sorted((s, e) for n, s, e in self.spans if n == name)
        if not ranges:
            return []
        starts = [s for s, _ in ranges]
        out = []
        for k in self.kernels:
            i = bisect.bisect_right(starts, k[3]) - 1
            if i >= 0 and k[3] <= ranges[i][1]:
                out.append(k)
        return out

    def span_count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.spans if n == name)

    def device_ops(self, top: int = 10) -> list:
        total = defaultdict(int)
        for name, s, e, _ in self.kernels:
            total[name] += e - s
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:160], ns * 1e-9] for name, ns in ranked]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle device time by the innermost host event (span or operator)
        open at the middle of each gap, found by one sweep over the host
        events in start order."""
        busy = self.busy_intervals()
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        mids = [((edges[i] + edges[i + 1]) // 2, edges[i + 1] - edges[i])
                for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        events = sorted(self.spans + self.host, key=lambda ev: ev[1])
        total = defaultdict(int)
        stack: list = []
        j = 0
        for mid, length in mids:
            while j < len(events) and events[j][1] <= mid:
                while stack and stack[-1][2] < events[j][1]:
                    stack.pop()
                stack.append(events[j])
                j += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            total[stack[-1][0] if stack else "host outside any span"] += length
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:160], ns * 1e-9] for name, ns in ranked]


_RUNTIME_PREFIXES = ("cuda", "cu", "hip")


def busy(fn) -> tuple[float, float]:
    """(busy seconds, window seconds) of ``fn()`` under a profiler of the
    device alone. The window is the host's clock from the start of ``fn``
    to the end of the device's work (the device is idle when it starts);
    the busy seconds are the merged device operations of the trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    tr = Trace()
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation():
            tr.kernels.append((ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns(), 0))
    if tr.kernels:
        tr.start = min(k[1] for k in tr.kernels)
        tr.end = max(k[2] for k in tr.kernels)
    return tr.busy_s, window_s


def record(fn) -> Trace:
    """Run ``fn()`` under the profiler; the device is synchronized before and
    after. Returns the reduced ``Trace``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    tr = Trace()
    launches = {}
    device = []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if ev.is_user_annotation():
                continue
            device.append((name, ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                           ev.correlation_id(), ev.linked_correlation_id()))
            continue
        span = (name, ev.start_ns(), ev.start_ns() + ev.duration_ns())
        if ev.is_user_annotation():
            if name == WINDOW:
                tr.start, tr.end = span[1], span[2]
            else:
                tr.spans.append(span)
        else:
            if name.startswith(_RUNTIME_PREFIXES):
                launches[ev.correlation_id()] = span[1]
            tr.host.append(span)
    for name, s, e, corr, linked in device:
        launch = launches.get(corr, launches.get(linked))
        if launch is not None:
            tr.kernels.append((name, s, e, launch))
        else:
            tr.unmatched.append(name)
    return tr
