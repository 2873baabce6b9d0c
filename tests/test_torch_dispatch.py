"""The port's kernel dispatch routes by what the model asked for: a tensor
goes to a kernel only when it lies on the card and the kernel takes its
dtype and head dim (``kernels/attention.py``: ``flash_takes``,
``packed_takes``, ``relpos_takes``; ``kernels/temporal_conv.py``:
``chain_takes``); everything else takes the plain versions on its own
device, so a float32 pipeline runs on the card. The card is stood in for
by ``_build.on_card``, the dispatch's one question about the device.
"""

import pytest
import torch

from t2v_torch.core.config import ModelScopeUNetConfig, T2VArgs
from t2v_torch.core.dtypes import Policy
from t2v_torch.kernels import _build
from t2v_torch.kernels import attention as tattn
from t2v_torch.kernels import flash_attention as tflash
from t2v_torch.kernels import fused_mha as tfused
from t2v_torch.kernels import relpos_mha as trelpos
from t2v_torch.kernels import temporal_conv as ttc
from t2v_torch.models.modelscope_unet import count_kernel_sites
from t2v_torch.pipeline.pipeline import ModelScopePipeline
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

DTYPES = (torch.bfloat16, torch.float16, torch.float32)
# head dims of the models: ModelScope's 64 (5, 10 and 20 heads), VideoCrafter's
# 40, 80 and 160 (8 heads), the VAE's single head of 512; and two no kernel takes
FLASH_DIMS = (40, 64, 80, 160, 512, 48, 32)
PACKED_HEADS = ((5, 64), (10, 64), (20, 64), (8, 40), (8, 80), (8, 160), (1, 512), (2, 32))
RELPOS_HEADS = ((8, 40), (8, 80), (8, 160), (4, 20), (1, 168))
CHANNELS = (320, 640, 1280, 64, 32)


def _routes(dtype):
    """Every route's answer for each model head dim and width at ``dtype``."""
    t = lambda *shape: torch.empty(shape, dtype=dtype)  # noqa: E731
    return ([tattn.flash_takes(t(1, 1, d)) for d in FLASH_DIMS]
            + [tattn.packed_takes(t(1, 1, h * d), h) for h, d in PACKED_HEADS]
            + [tattn.relpos_takes(t(1, 1, h * d), h) for h, d in RELPOS_HEADS]
            + [ttc.chain_takes(t(1, 1, 1, c)) for c in CHANNELS])


def test_route_predicates(monkeypatch):
    """On the card a kernel takes bf16 at its head dims and widths and
    nothing else; off the card nothing goes to a kernel."""
    bf16_routes = ([d in tflash.SUPPORTED_D for d in FLASH_DIMS]
                   + [d in tfused.HEAD_DIMS for _, d in PACKED_HEADS]
                   + [d % 8 == 0 and d <= trelpos.MAX_D for _, d in RELPOS_HEADS]
                   + [c % 64 == 0 for c in CHANNELS])
    assert not any(_routes(torch.bfloat16))  # CPU tensors
    monkeypatch.setattr(_build, "on_card", lambda t: True)
    for dtype in DTYPES:
        want = bf16_routes if dtype == torch.bfloat16 else [False] * len(bf16_routes)
        assert _routes(dtype) == want, dtype


def test_wrappers_refuse_what_the_dispatch_keeps_from_them():
    """The kernels' own argument checks still raise on float16 and float32
    (the dispatch does not loosen them)."""
    for dtype in (torch.float16, torch.float32):
        t = lambda *shape: torch.zeros(shape, dtype=dtype)  # noqa: E731
        calls = [
            lambda: tflash.check_args(t(2, 8, 64), t(2, 8, 64), t(2, 8, 64)),
            lambda: tfused.check_args(t(2, 24, 128), t(2, 24, 128), t(2, 24, 128), 2),
            lambda: tfused.check_cross_args(t(2, 24, 128), t(2, 77, 128), t(2, 77, 128), 2),
            lambda: trelpos.check_args(t(8, 6, 80), t(8, 6, 80), t(8, 6, 80), t(4, 4, 40),
                                       t(4, 4, 40), 2, 4),
            lambda: ttc.check_layer_args(t(2, 3, 8, 64), torch.zeros(2, 2, 64), torch.zeros(64),
                                         torch.zeros(64), t(3, 64, 64), torch.zeros(64)),
        ]
        for call in calls:
            with pytest.raises(ValueError):
                call()


class KernelReached(AssertionError):
    pass


def _bar_kernels(monkeypatch):
    """Every kernel wrapper the dispatch can hand a tensor to raises; the
    plain attention and chain are counted."""
    def barred(name):
        def call(*args, **kwargs):
            raise KernelReached(name)
        return call

    for name in ("flash_attention", "fused_self_mha", "fused_cross_mha", "fused_temporal_mha",
                 "relpos_mha"):
        monkeypatch.setattr(tattn, name, barred(name))
    monkeypatch.setattr(ttc, "temporal_conv_layer", barred("temporal_conv_layer"))
    counts = {"attention": 0, "chain": 0}

    def counted(key, fn):
        def call(*args, **kwargs):
            counts[key] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(tattn, "attention_plain", counted("attention", tattn.attention_plain))
    monkeypatch.setattr(ttc, "chain_plain", counted("chain", ttc.chain_plain))
    return counts


def test_float32_pipeline_on_the_card_routes_to_the_plain_versions(monkeypatch):
    """A float32 ModelScope pipeline whose widths the kernels take (64-wide
    heads, 64 and 128 channels) answers a request with every kernel wrapper
    barred and the card stood in for: every attention and temporal-conv
    call takes a plain version. The same pipeline in bf16 reaches a
    kernel, so the bar is live."""
    cfg = ModelScopeUNetConfig(dim=64, context_dim=64, dim_mult=(1, 2), num_res_blocks=1,
                               num_heads=1, head_dim=64, attn_scales=(1.0, 0.5))
    args = T2VArgs(prompt="a fox", seed=3, steps=1, frames=2, width=16, height=16, cfg_scale=9.0)
    counts = _bar_kernels(monkeypatch)
    monkeypatch.setattr(_build, "on_card", lambda t: True)
    res = ModelScopePipeline.random_init(cfg, Policy.fp32(), seed=0, device="cpu").infer(args)
    assert torch.isfinite(res.latents).all()
    # one CFG-batched UNet call: four layers a chain; every self-attention
    # site (flash or packed on the card) is among the plain attention calls
    sites = count_kernel_sites(cfg, 2, 2, 2)
    assert counts["chain"] == sites["temporal_conv"] // 4 > 0
    assert counts["attention"] >= sites["fused_self_mha"] + sites["flash_attention"] > 0
    with pytest.raises(KernelReached):
        ModelScopePipeline.random_init(cfg, Policy.bf16(), seed=0, device="cpu").infer(args)
