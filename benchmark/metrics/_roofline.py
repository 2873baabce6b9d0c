"""The share of a layer's roofline: its modules' least time over the device
time of what their spans launched, less the collective kernels (a block
whose frames are split over cards gathers them inside its span; that
exchange is ``collective_ms``'s). None where the trace holds no span of the
layer, or the card is not in benchmark/work/peaks.json."""

from benchmark.trace import is_collective


def share(run, span: str):
    tr, annot = run.trace, run.runner.annot
    if tr is None or run.peaks is None or not annot.calls.get(span):
        return None
    device_ns = sum(e - s for name, s, e, _ in tr.under(span) if not is_collective(name))
    if device_ns <= 0:
        return None
    return 100.0 * annot.least_s[span] / (device_ns * 1e-9)
