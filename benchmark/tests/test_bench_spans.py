"""The readers of the program's own spans (``benchmark/metrics/_spans.py``)
on a hand-made trace, and on the trace of a tiny request on the CPU."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import spec
from benchmark.trace import Trace


def _run(spans, kernels=()):
    return SimpleNamespace(trace=Trace(start=0, end=10_000_000, spans=spans,
                                       kernels=list(kernels)))


# two sampler steps of a request, each around one UNet call (the benchmark's
# own unet_call range between them), then two emits; two training steps
NESTED = [
    ("t2v.request", 0, 9_000_000), ("t2v.sample", 100_000, 6_000_000),
    ("t2v.step", 100_000, 3_100_000), ("unet_call", 400_000, 2_600_000),
    ("t2v.unet", 500_000, 2_500_000), ("t2v.unet.res", 600_000, 900_000),
    ("t2v.step", 3_100_000, 6_000_000), ("unet_call", 3_300_000, 5_700_000),
    ("t2v.unet", 3_400_000, 5_600_000),
    ("t2v.emit", 6_500_000, 7_000_000), ("t2v.emit", 7_000_000, 8_500_000),
    ("t2v.train.backward", 0, 4_000_000), ("t2v.train.backward", 5_000_000, 7_000_000),
    ("t2v.train.optimizer", 4_000_000, 4_500_000), ("t2v.train.optimizer", 7_000_000, 7_100_000),
]


# (name, start, end, launch): device operations of the request's spans above;
# one that runs past its span's end counts whole
KERNELS = [
    ("gemm", 700_000, 1_200_000, 650_000), ("norm", 1_200_000, 1_500_000, 2_400_000),
    ("gemm", 3_500_000, 4_300_000, 3_450_000), ("axpy", 5_900_000, 6_000_000, 5_800_000),
]


def test_readers_on_nested_spans():
    run = _run(NESTED, KERNELS)
    assert spec.reader("unet_host_ms.request")(run) == pytest.approx(2.1)
    # steps of 3.0 and 2.9 ms less their UNet calls of 2.0 and 2.2 ms; the
    # benchmark's unet_call range and the block inside the call are not taken off
    assert spec.reader("sampler_ms.request")(run) == pytest.approx(0.85)
    assert spec.reader("sampler_ms.batch")(run) == pytest.approx(0.85)
    assert spec.reader("emit_ms.batch")(run) == pytest.approx(1.0)
    assert spec.reader("backward_ms.train")(run) == pytest.approx(3.0)
    assert spec.reader("optimizer_ms.train")(run) == pytest.approx(0.3)
    # 0.5 + 0.3 ms launched in the first call, 0.8 ms in the second; the
    # axpy was launched after the second call's span ended
    assert spec.reader("unet_device_ms.request")(run) == pytest.approx(0.8)


def test_device_time_of_the_backward():
    """Kernels the autograd engine's thread launched count by their launch
    time inside ``t2v.train.backward``, whole even where they end after it."""
    run = _run([("t2v.train.forward", 0, 1_000_000), ("t2v.train.backward", 1_000_000, 4_000_000),
                ("t2v.train.forward", 5_000_000, 6_000_000),
                ("t2v.train.backward", 6_000_000, 7_000_000)],
               [("fwd", 200_000, 900_000, 100_000), ("mm_bwd", 1_500_000, 5_500_000, 3_900_000),
                ("mm_bwd", 6_500_000, 6_700_000, 6_900_000), ("fwd", 6_000_000, 6_100_000, 5_900_000)])
    # 4.0 + 0.2 ms over two backwards
    assert spec.reader("backward_device_ms.train")(run) == pytest.approx(2.1)


def test_a_unet_call_outside_every_step_is_not_taken_off():
    run = _run([("t2v.step", 0, 1_000_000), ("t2v.unet", 200_000, 700_000),
                ("t2v.unet", 1_500_000, 1_800_000)])
    assert spec.reader("sampler_ms.request")(run) == pytest.approx(0.5)


@pytest.mark.parametrize("metric", ["unet_host_ms.request", "sampler_ms.request",
                                    "emit_ms.batch", "backward_ms.train", "optimizer_ms.train",
                                    "unet_device_ms.request", "backward_device_ms.train"])
def test_none_without_the_programs_spans(metric):
    # the benchmark's own ranges alone, as on a program without spans
    run = _run([("unet_call", 0, 10), ("decode", 20, 30)], [("gemm", 2, 8, 1)])
    assert spec.reader(metric)(run) is None
    assert spec.reader(metric)(SimpleNamespace(trace=None)) is None


def test_readers_on_a_tiny_request_trace(monkeypatch):
    """``trace.record`` of two tiny requests through ``run`` on the CPU (the
    device's synchronize stubbed): the program's spans reach the readers."""
    from benchmark import trace as tracing
    from benchmark.loops.request import Loop
    from benchmark.tests.conftest import tiny_cell

    cell = tiny_cell("ms24f-batch4", batch_count=2)
    loop = Loop(cell.config, cell.traffic, 7, torch.device("cpu"), None)
    loop.setup()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    try:
        run = SimpleNamespace(trace=tracing.record(lambda: loop.unit(1)))
    finally:
        loop.release()
    steps = cell.traffic["steps"]
    assert run.trace.span_count("t2v.step") == steps
    assert run.trace.span_count("t2v.emit") == 2
    for metric in ("unet_host_ms.request", "sampler_ms.batch", "emit_ms.batch"):
        assert spec.reader(metric)(run) > 0, metric
