"""The port's ``t2v.*`` spans (``t2v_torch/core/profiling.py::span``) under a
CPU ``torch.profiler``, on tiny pipelines: each layer's range nests inside
its caller's, and without a profiler no range is opened at all.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_spans.py -q
"""

from __future__ import annotations

import json
import os
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from t2v_torch.core import profiling
from t2v_torch.core.config import T2VArgs, T2VOutputArgs, VideoCrafterUNetConfig
from t2v_torch.pipeline.pipeline import ModelScopePipeline
from t2v_torch.pipeline.videocrafter import VideoCrafterPipeline
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARGS = T2VArgs(prompt="a cat", n_prompt="", steps=2, frames=2, width=32, height=32, seed=3,
               cfg_scale=5.0)


@pytest.fixture(scope="module")
def ms_pipe():
    return ModelScopePipeline.random_init(device="cpu")


@pytest.fixture(scope="module")
def vc_pipe():
    return VideoCrafterPipeline.random_init(VideoCrafterUNetConfig().tiny(), device="cpu")


def _spans(fn):
    """(name, start, end) of every ``t2v.*`` range recorded while ``fn()``
    runs under a CPU profiler, in start order; and ``fn``'s value."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
                    for ev in prof.profiler.kineto_results.events()
                    if ev.name().startswith("t2v.")), key=lambda s: (s[1], -s[2]))
    return spans, out


def _inside(spans, outer: str, inner: str) -> Counter:
    """How many ``inner`` ranges lie within each ``outer`` range, by the
    outer range's index."""
    outs = [s for s in spans if s[0] == outer]
    return Counter(i for n, a, b in spans if n == inner
                   for i, (_, s, e) in enumerate(outs) if s <= a and b <= e)


def _request_tree(spans, steps: int, kinds: set[str]) -> None:
    names = Counter(n for n, _, _ in spans)
    assert names["t2v.request"] == 1
    for phase in ("t2v.text", "t2v.sample", "t2v.decode"):
        assert names[phase] == 1 and _inside(spans, "t2v.request", phase) == {0: 1}, phase
    assert _inside(spans, "t2v.sample", "t2v.step") == {0: steps}
    unets = names["t2v.unet"]
    assert unets >= steps and sum(_inside(spans, "t2v.step", "t2v.unet").values()) == unets
    blocks = {n for n in names if n.startswith("t2v.unet.")}
    assert {"t2v.unet." + k for k in kinds} <= blocks
    per_call = _inside(spans, "t2v.unet", "t2v.unet.res")
    assert len(per_call) == unets and len(set(per_call.values())) == 1
    assert sum(names[b] for b in blocks) == sum(
        sum(_inside(spans, "t2v.unet", b).values()) for b in blocks)


def test_span_is_a_flag_test_without_a_profiler(monkeypatch):
    """No profiler: ``span`` returns the shared no-op context and never
    reaches ``record_function``; under one it opens a range with args."""
    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("t2v.x") is profiling.span("t2v.y") is profiling._OFF
    with profiling.span("t2v.x", "7"):
        pass
    pt = profiling.PhaseTimes()
    with pt.phase("text"):
        pass
    assert set(pt.times) == {"text"}
    monkeypatch.undo()

    def opened():
        with profiling.span("t2v.x", "7"):
            pass

    spans, _ = _spans(opened)
    assert [n for n, _, _ in spans] == ["t2v.x"]


def test_modelscope_request_spans(ms_pipe):
    spans, res = _spans(lambda: ms_pipe.infer(ARGS))
    _request_tree(spans, 2, {"conv_in", "res", "spatial", "temporal", "downsample", "upsample"})
    assert set(res.timings) == {"text", "sample", "decode"}


@pytest.mark.parametrize("sample_type", ["ddim", "dpm++ 2m"])
def test_videocrafter_request_spans(vc_pipe, sample_type):
    spans, res = _spans(lambda: vc_pipe.infer(ARGS, sample_type=sample_type))
    _request_tree(spans, ARGS.steps, {"conv_in", "res", "st", "downsample", "upsample"})
    assert set(res.timings) == {"text", "sample", "decode"}


def test_run_dp_phases_timings_and_manifest(ms_pipe, tmp_path):
    from t2v_torch.pipeline import run as run_mod

    saved = run_mod._warm_pipe
    try:
        spans, res = _spans(lambda: run_mod.run(
            ARGS.replace(batch_count=2), T2VOutputArgs(skip_video_creation=True), pipe=ms_pipe,
            outdir=str(tmp_path), dp_shards=2, device="cpu"))
    finally:
        run_mod._warm_pipe = saved
    names = Counter(n for n, _, _ in spans)
    assert names["t2v.request"] == 1 and names["t2v.text"] == names["t2v.sample"] == 1
    assert names["t2v.emit"] == names["t2v.decode"] == 2 and names["t2v.step"] == 2
    assert _inside(spans, "t2v.request", "t2v.emit") == {0: 2}
    assert set(res.timings) == {"text", "sample", "decode", "emit"}
    assert all(v > 0 for v in res.timings.values())
    for d in res.frame_dirs:
        with open(os.path.join(d, "manifest.json")) as f:
            phases = json.load(f)["phase_times"]
        assert set(phases) == {"text", "sample", "decode"} and all(v > 0 for v in phases.values())


def test_lora_train_step_spans():
    from t2v_torch.core.config import ModelScopeUNetConfig
    from t2v_torch.diffusion.schedules import DiffusionSchedule
    from t2v_torch.models.modelscope_unet import UNetSD
    from t2v_torch.parallel.train import (init_train_state, make_lora_train_step,
                                          make_optimizer, module_apply_fn)
    from t2v_torch.pipeline.lora import init_lora, unet_module_index

    cfg = ModelScopeUNetConfig().tiny()
    torch.manual_seed(0)
    unet = UNetSD(cfg).requires_grad_(False)
    base = dict(unet.named_parameters())
    index = unet_module_index(cfg)
    tree = init_lora(base, index, 2, torch.Generator().manual_seed(0))
    state = init_train_state(tree, make_optimizer(1e-3))
    step = make_lora_train_step(module_apply_fn(unet), DiffusionSchedule.linear_sd(1000), base,
                                index, alpha=2)
    batch = {"latents": torch.randn(1, 2, 8, 8, cfg.in_dim),
             "context": torch.randn(1, 3, cfg.context_dim)}
    gen = torch.Generator().manual_seed(1)

    spans, _ = _spans(lambda: step(state, batch, gen))
    names = Counter(n for n, _, _ in spans)
    for phase in ("forward", "backward", "optimizer"):
        assert names["t2v.train." + phase] == 1, phase
    assert names["t2v.train.grad_sum"] == 0  # no mesh: no bucketed sums
    assert _inside(spans, "t2v.train.forward", "t2v.unet") == {0: 1}
