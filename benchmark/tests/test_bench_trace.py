"""The reduction of a device timeline (``benchmark/trace.py``) and the
readers that take their numbers from it, on a hand-made trace."""

from types import SimpleNamespace

import pytest

from benchmark import spec
from benchmark.trace import Trace


def _trace():
    # window 0..1000 ns; two UNet calls launch three kernels each, an
    # attention span inside the first call launches two of them
    tr = Trace(start=0, end=1000)
    tr.spans = [("unet_call", 100, 400), ("attention", 150, 250), ("unet_call", 500, 800)]
    tr.host = [("aten::mm", 160, 170), ("aten::add", 600, 620), ("cudaLaunchKernel", 605, 610)]
    tr.kernels = [("gemm", 200, 300, 160), ("softmax", 300, 350, 200), ("gn", 400, 420, 300),
                  ("gemm", 610, 700, 605), ("gn", 700, 720, 650), ("copy", 900, 950, 790),
                  ("late", 980, 1100, 990)]
    return tr


def test_busy_and_window():
    tr = _trace()
    assert tr.window_s == pytest.approx(1000e-9)
    # 200..350, 400..420, 610..720, 900..950, 980..1000 (clipped to the window)
    assert tr.busy_s == pytest.approx((150 + 20 + 110 + 50 + 20) * 1e-9)


def test_launches_under_spans():
    tr = _trace()
    assert [k[0] for k in tr.under("attention")] == ["gemm", "softmax"]
    assert len(tr.under("unet_call")) == 6
    assert tr.span_count("unet_call") == 2


def test_breakdown():
    tr = _trace()
    ops = dict(tr.device_ops())
    assert ops["gemm"] == pytest.approx(190e-9)
    gaps = dict(tr.idle_gaps())
    # 0..200 (host in unet_call at its middle, 100), 350..400 and 420..610 (in
    # unet_call), 720..900 (mid 810: outside any span), 950..980 (outside)
    assert gaps["unet_call"] == pytest.approx((200 + 50 + 190) * 1e-9)
    assert gaps["host outside any span"] == pytest.approx((180 + 30) * 1e-9)


def test_trace_readers():
    tr = _trace()
    annot = SimpleNamespace(calls={"attention": 1}, least_s={"attention": 75e-9})
    run = SimpleNamespace(trace=tr, peaks={"flops": 1.0, "bytes_per_s": 1.0},
                          runner=SimpleNamespace(annot=annot), busy=(350e-9, 1000e-9))
    assert spec.reader("launches_per_call.request")(run) == 3
    # 350 ns busy in a traced window of 1,000 ns
    assert spec.reader("device_idle.request")(run) == pytest.approx(65.0)
    run.busy = (tr.busy_s, tr.window_s)
    assert spec.reader("device_idle.train")(run) == pytest.approx(65.0)
    run.busy = None
    assert spec.reader("device_idle.batch")(run) is None
    # 75 ns of least time over 150 ns of device time under the attention span
    assert spec.reader("attention_roofline.request")(run) == pytest.approx(50.0)
    assert spec.reader("temporal_conv_roofline.request")(run) is None
