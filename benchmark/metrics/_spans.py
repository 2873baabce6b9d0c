"""The program's own spans (``t2v.*`` ranges that
``t2v_torch/core/profiling.py::span`` opens while a profiler records) in the
traced units: their durations, host time on the profiler's clock, so each
operator's profiling cost is in it; and the device time launched inside
them, which the profiler does not stretch. None where the trace holds no
such span, as on a program without them."""

import bisect


def _ranges(run, name: str) -> list:
    tr = run.trace
    return sorted((s, e) for n, s, e in tr.spans if n == name) if tr is not None else []


def mean_ms(run, name: str):
    """Mean duration of the spans called ``name``, in ms."""
    ranges = _ranges(run, name)
    return sum(e - s for s, e in ranges) / len(ranges) * 1e-6 if ranges else None


def mean_self_ms(run, name: str, inner: str):
    """Mean duration of the spans called ``name`` less the ``inner`` spans
    inside each, in ms."""
    ranges = _ranges(run, name)
    if not ranges:
        return None
    starts = [s for s, _ in ranges]
    own = [e - s for s, e in ranges]
    for s, e in _ranges(run, inner):
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= ranges[i][1]:
            own[i] -= e - s
    return sum(own) / len(own) * 1e-6


def device_ms(run, name: str):
    """Summed durations of the device operations launched inside the spans
    called ``name``, over the number of spans, in ms."""
    tr = run.trace
    n = tr.span_count(name) if tr is not None else 0
    return sum(e - s for _, s, e, _ in tr.under(name)) / n * 1e-6 if n else None
