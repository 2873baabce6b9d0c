"""The port's ``UNetSD`` against the JAX package's at the tiny config in
fp32, the UNet converter round trip, and the kernel-site count that the
GPU smoke run holds the launch counters to.

Tolerance of the forward: 2e-4 absolute and relative. Both sides compute
in float32 in another summation order; through the tiny UNet's 20-odd
blocks the difference stays near 1e-5 of O(1) outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v.core.config import ModelScopeUNetConfig as JCfg
from t2v.io.convert import convert_unet
from t2v.models.modelscope_unet import UNetSD as JUNet
from t2v_torch.core.config import ModelScopeUNetConfig
from t2v_torch.io import convert
from t2v_torch.models import blocks as TB
from t2v_torch.models.modelscope_unet import UNetSD, build_topology, count_kernel_sites
from t2v_torch.pipeline.pipeline import init_weights
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = ModelScopeUNetConfig().tiny()
FRAMES = 3


@pytest.fixture(scope="module")
def jax_params():
    """JAX parameters made from a seeded port UNet through the JAX
    package's own converter (initialising the JAX UNet would cost a 25 s
    compile), every leaf then perturbed so that no zero-initialised gate
    or constant hides a layout bug."""
    unet = UNetSD(CFG)
    init_weights(unet, 0)
    sd = {k: v.numpy() for k, v in unet.state_dict().items()}
    params = convert_unet(sd, JCfg().tiny())
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + 0.02 * rng.normal(size=np.shape(a)).astype(np.float32),
        params,
    )


def test_tiny_unet_matches_jax(jax_params):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, FRAMES, 8, 8, 4)).astype(np.float32)
    t = np.array([981.0, 1.0], np.float32)
    ctx = rng.normal(size=(2, 77, CFG.context_dim)).astype(np.float32)
    want = np.asarray(jax.jit(JUNet(cfg=JCfg().tiny()).apply)(
        jax_params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    unet = convert.load_into(UNetSD(CFG), convert.from_jax_unet(jax_params, CFG)).eval()
    with torch.no_grad():
        got = unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx)).numpy()
    assert got.shape == (2, FRAMES, 8, 8, 4)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_from_jax_unet_round_trips_through_convert_unet(jax_params):
    sd = convert.from_jax_unet(jax_params, CFG)
    back = convert_unet(sd, JCfg().tiny())
    flat_a = jax.tree_util.tree_leaves_with_path(jax_params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_state_dict_keys_are_the_reference_keys(jax_params):
    sd = convert.from_jax_unet(jax_params, CFG)
    own = UNetSD(CFG).state_dict()
    assert set(own) == set(sd)
    for k, v in own.items():
        assert tuple(v.shape) == sd[k].shape, k
    assert "input_blocks.1.0.temopral_conv.conv1.2.weight" in own
    assert "input_blocks.1.1.transformer_blocks.0.attn1.to_q.weight" in own


def test_topology_matches_jax():
    from t2v.models.modelscope_unet import build_topology as j_build

    for cfg in (ModelScopeUNetConfig(), CFG):
        jcfg = JCfg(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
        mine, theirs = build_topology(cfg), j_build(jcfg)
        assert [[tuple(vars(d).values()) for d in e] for e in (*mine.encoder, mine.middle, *mine.decoder)] \
            == [[tuple(vars(d).values()) for d in e] for e in (*theirs.encoder, theirs.middle, *theirs.decoder)]


def test_kernel_sites_of_the_main_path():
    # full UNet, 24 frames at a 32x32 latent: 22 ResBlocks x 4 temporal-conv
    # layers, 5 spatial self-attentions at 1024 tokens, 11 below 512 tokens
    # and 17 temporal transformers with two self-attentions each
    assert count_kernel_sites(ModelScopeUNetConfig(), 24, 32, 32) == {
        "temporal_conv": 88, "flash_attention": 5, "fused_self_mha": 45}


def test_kernel_sites_match_the_dispatch_calls(monkeypatch):
    seen = {"temporal_conv": 0, "flash_attention": 0, "fused_self_mha": 0}
    real_attn, real_chain = TB.self_attention_packed, TB.temporal_conv_chain

    def attn(q, k, v, heads, scale=None):
        seen["fused_self_mha" if q.shape[1] < 512 else "flash_attention"] += 1
        return real_attn(q, k, v, heads, scale)

    def chain(x, layers, eps=1e-5):
        seen["temporal_conv"] += len(layers)
        return real_chain(x, layers, eps)

    monkeypatch.setattr(TB, "self_attention_packed", attn)
    monkeypatch.setattr(TB, "temporal_conv_chain", chain)
    unet = UNetSD(CFG).eval()
    with torch.no_grad():
        unet(torch.zeros(1, FRAMES, 8, 8, 4), torch.zeros(1), torch.zeros(1, 77, CFG.context_dim))
    assert seen == count_kernel_sites(CFG, FRAMES, 8, 8)
