"""The long-video (125 and 250 frame) side of the port on the CPU, in fp32.

The JAX package runs long videos through a second, frame-chunked Pallas
kernel (``_chunked_layer_kernel``), chosen by ``_pick_blocks_chunked``; the
port's one layer kernel takes any frame count. Here the port's plain chain
is held against the JAX package's chain in interpret mode with the chunked
pick forced (the chunk's halo masking at both ends of the video and the
per-chunk statistics partials are what could differ), and at the 125-frame
shape; the statistics walk, the temporal attention at N = 125 and 250, and
the launch count of a 125-frame UNet call are checked beside it.

Tolerance: rtol = atol = 2e-4, float32 on both sides in another summation
order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import t2v.kernels.temporal_conv as jtc
from t2v.kernels.fused_mha import fused_self_mha as j_fused_self_mha
from t2v_torch.core.config import ModelScopeUNetConfig
from t2v_torch.kernels import temporal_conv as ttc
from t2v_torch.kernels.fused_mha import fused_self_mha
from t2v_torch.models import blocks as TB
from t2v_torch.models.modelscope_unet import UNetSD, count_kernel_sites
from t2v_torch.pipeline.pipeline import decode_chunk_frames
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=2e-4, atol=2e-4)


def _chain_inputs(seed, b, f, hw, c, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (scale * rng.normal(size=(b, f, hw, c))).astype(np.float32)
    layers = [(
        (1.0 + 0.1 * rng.normal(size=(c,))).astype(np.float32),
        (0.1 * rng.normal(size=(c,))).astype(np.float32),
        (rng.normal(size=(3, c, c)) / np.sqrt(3 * c)).astype(np.float32),
        (0.1 * rng.normal(size=(c,))).astype(np.float32),
    ) for _ in range(4)]
    return x, layers


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _jax_chain(x, layers):
    return np.asarray(jtc.temporal_conv_chain(
        jnp.asarray(x), [tuple(map(jnp.asarray, l)) for l in layers], interpret=True))


# (frame chunk, spatial tile, output-channel block): chunks of 4, 3 and 6
# frames of a 12-frame video, one of them combined with channel blocking
@pytest.mark.parametrize("pick", [(4, 8, 64), (3, 8, 32), (6, 8, 64)])
def test_chain_matches_the_frame_chunked_pallas_kernel(monkeypatch, pick):
    x, layers = _chain_inputs(21, 2, 12, 16, 64)
    monkeypatch.setattr(jtc, "_pick_blocks_chunked", lambda *a, **k: pick)
    want = _jax_chain(x, layers)
    t_layers = [tuple(map(_t, l)) for l in layers]
    np.testing.assert_allclose(ttc.chain_plain(_t(x), t_layers).numpy(), want, **TOL)
    np.testing.assert_allclose(ttc.temporal_conv_chain(_t(x), t_layers).numpy(), want, **TOL)


def test_chain_matches_pallas_interpret_at_125_frames():
    c, hw, f = 128, 64, 125
    assert jtc._pick_blocks(hw, f, c) is not None
    x, layers = _chain_inputs(22, 1, f, hw, c, scale=0.5)
    want = _jax_chain(x, layers)
    ref = np.asarray(jtc.chain_ref(jnp.asarray(x), [tuple(map(jnp.asarray, l)) for l in layers]))
    t_layers = [tuple(map(_t, l)) for l in layers]
    got = ttc.temporal_conv_chain(_t(x), t_layers).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(ttc.chain_plain(_t(x), t_layers).numpy(), ref, **TOL)


def test_end_frames_are_zero_after_the_activation():
    """A one-frame video has no neighbours: taps 0 and 2 must add nothing,
    not silu(norm(0)) (which the GroupNorm bias makes non-zero)."""
    x, layers = _chain_inputs(23, 1, 1, 8, 64)
    xt = _t(x)
    fin = ttc.finalize_stats(ttc.input_stats(xt), 8, 1e-5)
    scale, bias, w, cb = map(_t, layers[0])
    y, _ = ttc.temporal_conv_layer(xt, fin, scale, bias + 1.0, w, cb)
    w_mid = torch.zeros_like(w)
    w_mid[1] = w[1]
    y_mid, _ = ttc.temporal_conv_layer(xt, fin, scale, bias + 1.0, w_mid, cb)
    np.testing.assert_allclose(y.numpy(), y_mid.numpy(), rtol=1e-6, atol=1e-6)


def test_input_stats_walks_frame_chunks(monkeypatch):
    x = _t(_chain_inputs(24, 2, 125, 16, 64)[0])
    whole = ttc.input_stats(x)
    monkeypatch.setattr(ttc, "STATS_CHUNK_ELEMENTS", 7 * 2 * 16 * 64)  # 7 frames at a time
    chunked = ttc.input_stats(x)
    want = np.asarray(jtc.input_stats(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(chunked.numpy(), want, rtol=1e-5, atol=1e-4)
    x16 = x.to(torch.bfloat16)
    assert ttc.input_stats(x16).dtype == torch.float32
    np.testing.assert_allclose(ttc.input_stats(x16).numpy(), ttc.input_stats(x16.float()).numpy(),
                               rtol=1e-6)


# temporal self-attention over 125 and 250 frames: neither is a multiple of
# the kernels' 16-row tiles
@pytest.mark.parametrize("n", [125, 250])
def test_fused_self_mha_plain_at_long_frame_counts(n):
    rng = np.random.default_rng(n)
    q, k, v = (rng.normal(size=(3, n, 2 * 64)).astype(np.float32) for _ in range(3))
    want = np.asarray(j_fused_self_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       heads=2, interpret=True))
    got = fused_self_mha(_t(q), _t(k), _t(v), 2).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_kernel_sites_at_125_frames():
    # the frame count moves no attention to another kernel below 512 frames
    assert count_kernel_sites(ModelScopeUNetConfig(), 125, 32, 32) == \
        count_kernel_sites(ModelScopeUNetConfig(), 24, 32, 32)
    assert count_kernel_sites(ModelScopeUNetConfig(), 600, 32, 32) == {
        "temporal_conv": 88, "flash_attention": 39, "fused_self_mha": 11}
    # 125 frames at 256x256 decode in two calls of 63 frames
    assert decode_chunk_frames(125, 256, 256) == 63
    assert decode_chunk_frames(24, 256, 256) == 122


def test_kernel_sites_match_the_dispatch_calls_at_125_frames(monkeypatch):
    cfg = ModelScopeUNetConfig().tiny()
    seen = {"temporal_conv": 0, "flash_attention": 0, "fused_self_mha": 0}
    real_attn, real_chain = TB.self_attention_packed, TB.temporal_conv_chain
    frames_seen = set()

    def attn(q, k, v, heads, scale=None):
        seen["fused_self_mha" if q.shape[1] < 512 else "flash_attention"] += 1
        return real_attn(q, k, v, heads, scale)

    def chain(x, layers, eps=1e-5):
        seen["temporal_conv"] += len(layers)
        frames_seen.add(x.shape[1])
        return real_chain(x, layers, eps)

    monkeypatch.setattr(TB, "self_attention_packed", attn)
    monkeypatch.setattr(TB, "temporal_conv_chain", chain)
    unet = UNetSD(cfg).eval()
    with torch.no_grad():
        out = unet(torch.zeros(1, 125, 4, 4, 4), torch.zeros(1), torch.zeros(1, 77, cfg.context_dim))
    assert out.shape == (1, 125, 4, 4, 4)
    assert frames_seen == {125}
    assert seen == count_kernel_sites(cfg, 125, 4, 4)
