"""The port's VideoCrafter UNet against the JAX package's in fp32 on the
CPU: the temporal attention in both layouts, the ST block, the ResBlock with
the decoder's concat pair, the tiny UNet, the converter round trip, the
topology copy, and the kernel-site count that the GPU smoke run holds the
launch counters to.

Weights go from the port to JAX through the JAX package's own
``convert_vc_unet`` (the port's modules carry the Lightning checkpoint's key
names) and back through ``from_jax_vc_unet``. Tolerance: rtol = atol = 2e-4,
float32 on both sides in another summation order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v.core.dtypes import Policy as JPolicy
from t2v.io.convert_vc import _res_block, _st_block, _temporal_attn, convert_vc_unet
from t2v.models import videocrafter_unet as jvc
from t2v_torch.core.config import VideoCrafterUNetConfig
from t2v_torch.io import convert
from t2v_torch.models import blocks as TB
from t2v_torch.models import videocrafter_unet as tvc
from t2v_torch.pipeline.pipeline import init_weights
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=2e-4, atol=2e-4)
CFG = VideoCrafterUNetConfig().tiny()
JCFG = jvc.VideoCrafterUNetConfig().tiny()
FRAMES = 4


def _randomised(module: torch.nn.Module, seed: int) -> dict:
    """Seed the module, then perturb every leaf (the zero-initialised ones
    too), so that no gate or constant hides a layout bug; returns the numpy
    state dict."""
    init_weights(module, seed)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(torch.from_numpy(0.02 * rng.normal(size=tuple(p.shape)).astype(np.float32)))
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _prefixed(sd: dict, prefix: str) -> dict:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


@pytest.mark.parametrize("frame_split", [None, 5])
def test_temporal_cross_attention_matches_jax(frame_split):
    dim, heads, dh, t = 16, 2, 8, 5
    mod = tvc.TemporalCrossAttention(dim, heads, dh, temporal_length=t).eval()
    params = {"params": _temporal_attn(_prefixed(_randomised(mod, 0), "a"), "a")}
    rng = np.random.default_rng(1)
    shape = (2 * t, 12, dim) if frame_split else (3, t, dim)
    x = rng.normal(size=shape).astype(np.float32)
    for backend in ("xla", "fused_interpret"):
        jmod = jvc.TemporalCrossAttention(
            query_dim=dim, heads=heads, dim_head=dh, temporal_length=t, frame_split=frame_split,
            policy=dataclasses.replace(JPolicy(), attention_backend=backend))
        want = np.asarray(jmod.apply(params, jnp.asarray(x)))
        with torch.no_grad():
            got = mod(torch.from_numpy(x), frame_split=frame_split).numpy()
        np.testing.assert_allclose(got, want, **TOL)


def test_temporal_cross_attention_without_relative_position_and_mask():
    dim, heads, dh, t = 16, 2, 8, 4
    mod = tvc.TemporalCrossAttention(dim, heads, dh, use_relative_position=False).eval()
    params = {"params": _temporal_attn(_prefixed(_randomised(mod, 2), "a"), "a")}
    x = np.random.default_rng(3).normal(size=(2 * t, 6, dim)).astype(np.float32)
    jmod = jvc.TemporalCrossAttention(query_dim=dim, heads=heads, dim_head=dh,
                                      use_relative_position=False, frame_split=t)
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = mod(torch.from_numpy(x), frame_split=t).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        mod(torch.from_numpy(x), frame_split=t, mask=torch.ones(t, t))


def test_zero_initialised_temporal_attention_is_identity_on_time():
    from t2v_torch.pipeline.videocrafter import _ZERO_INIT

    block = tvc.BasicTransformerBlockST(16, 2, 8, context_dim=12, temporal_length=4)
    init_weights(block, 0, _ZERO_INIT)
    x = torch.randn(6, 4, 16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert not block.attn1_tmp(x).any() and not block.attn2_tmp(x).any()
    assert block.attn1.to_q.weight.any()


@pytest.mark.parametrize("with_context", [True, False])
def test_st_block_matches_jax(with_context):
    dim, heads, dh, t, ctx_dim = 16, 2, 8, 4, 12
    block = tvc.BasicTransformerBlockST(dim, heads, dh, ctx_dim if with_context else None, t).eval()
    params = {"params": _st_block(_prefixed(_randomised(block, 4), "b"), "b")}
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, t, 3, 4, dim)).astype(np.float32)
    ctx = rng.normal(size=(2, 7, ctx_dim)).astype(np.float32) if with_context else None
    jblock = jvc.BasicTransformerBlockST(dim=dim, heads=heads, dim_head=dh,
                                         context_dim=ctx_dim if with_context else None,
                                         temporal_length=t)
    want = np.asarray(jblock.apply(params, jnp.asarray(x),
                                   context=None if ctx is None else jnp.asarray(ctx)))
    with torch.no_grad():
        got = block(torch.from_numpy(x), None if ctx is None else torch.from_numpy(ctx)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


# plain input with and without the 1x1x1 skip; the decoder's (upsampled, skip)
# pair, which the port concatenates; a temporal kernel of 3 frames
@pytest.mark.parametrize("ch,out,pair,kt", [(32, 32, None, 1), (32, 64, None, 1),
                                            (96, 32, 64, 1), (32, 64, None, 3)])
def test_resblock3d_matches_jax(ch, out, pair, kt):
    emb = 24
    block = tvc.ResBlock3D(ch, out, emb, kt, kt // 2).eval()
    params = {"params": _res_block(_prefixed(_randomised(block, 6), "r"), "r", has_skip=ch != out)}
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 3, 4, 4, ch)).astype(np.float32)
    e = rng.normal(size=(2, emb)).astype(np.float32)
    jblock = jvc.ResBlock3D(channels=ch, out_channels=out, emb_channels=emb, kernel_size_t=kt,
                            padding_t=kt // 2)
    jx = jnp.asarray(x)
    if pair:
        jx = (jx[..., :pair], jx[..., pair:])
    want = np.asarray(jblock.apply(params, jx, jnp.asarray(e)))
    with torch.no_grad():
        got = block(torch.from_numpy(x), torch.from_numpy(e)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.fixture(scope="module")
def jax_params():
    """JAX parameters of the tiny UNet, made from a seeded and perturbed port
    UNet through the JAX package's own converter."""
    return convert_vc_unet(_randomised(tvc.VideoCrafterUNet(CFG), 8), JCFG)


def test_tiny_unet_matches_jax(jax_params):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, FRAMES, 8, 8, 4)).astype(np.float32)
    t = np.array([981.0, 1.0], np.float32)
    ctx = rng.normal(size=(2, 77, CFG.context_dim)).astype(np.float32)
    tc = rng.normal(size=(1, CFG.model_channels * 4)).astype(np.float32)
    japply = jax.jit(jvc.VideoCrafterUNet(cfg=JCFG).apply)
    unet = convert.load_into(tvc.VideoCrafterUNet(CFG),
                             convert.from_jax_vc_unet(jax_params, CFG)).eval()
    for kwargs in ({}, {"temporal_context": tc}):
        want = np.asarray(japply(jax_params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                                 **{k: jnp.asarray(v) for k, v in kwargs.items()}))
        with torch.no_grad():
            got = unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                       **{k: torch.from_numpy(v) for k, v in kwargs.items()}).numpy()
        assert got.shape == (2, FRAMES, 8, 8, 4)
        np.testing.assert_allclose(got, want, **TOL)


def test_from_jax_vc_unet_round_trips_through_convert_vc_unet(jax_params):
    sd = convert.from_jax_vc_unet(jax_params, CFG)
    back = convert_vc_unet(sd, JCFG)
    flat_a = jax.tree_util.tree_leaves_with_path(jax_params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_state_dict_keys_are_the_lightning_keys(jax_params):
    sd = convert.from_jax_vc_unet(jax_params, CFG)
    own = tvc.VideoCrafterUNet(CFG).state_dict()
    assert set(own) == set(sd)
    for k, v in own.items():
        assert tuple(v.shape) == sd[k].shape, k
    assert "input_blocks.1.1.transformer_blocks.0.attn1_tmp.relative_position_k.embeddings_table" in own
    assert "input_blocks.2.0.op.weight" in own and "output_blocks.1.1.conv.weight" in own


@pytest.mark.parametrize("cfg", [VideoCrafterUNetConfig(), CFG], ids=["full", "tiny"])
def test_vc_topology_matches_jax(cfg):
    jcfg = jvc.VideoCrafterUNetConfig(**dataclasses.asdict(cfg))
    mine, theirs = tvc.build_vc_topology(cfg), jvc.build_vc_topology(jcfg)
    flat = lambda topo: [[tuple(vars(d).values()) for d in e]
                         for e in (*topo.encoder, topo.middle, *topo.decoder)]
    assert flat(mine) == flat(theirs)


def test_vc_kernel_sites_of_the_main_path():
    # full UNet, 16 frames at a 32x32 latent: 16 ST blocks (6 encoder, 1
    # middle, 9 decoder); 5 of them at 1,024 tokens
    assert tvc.count_vc_kernel_sites(VideoCrafterUNetConfig(), 16, 32, 32) == {
        "relpos_mha": 32, "fused_cross_mha": 16, "flash_attention": 5, "fused_self_mha": 11}


@pytest.mark.parametrize("hw", [8, 32])
def test_vc_kernel_sites_match_the_dispatch_calls(monkeypatch, hw):
    seen = {"relpos_mha": 0, "fused_cross_mha": 0, "flash_attention": 0, "fused_self_mha": 0}

    def counting(name, real, pick=None):
        def wrapped(q, *args, **kwargs):
            seen[pick(q) if pick else name] += 1
            return real(q, *args, **kwargs)
        return wrapped

    monkeypatch.setattr(TB, "self_attention_packed", counting(
        None, TB.self_attention_packed,
        lambda q: "fused_self_mha" if q.shape[1] < 512 else "flash_attention"))
    monkeypatch.setattr(TB, "cross_attention_packed",
                        counting("fused_cross_mha", TB.cross_attention_packed))
    monkeypatch.setattr(tvc, "relpos_attention", counting("relpos_mha", tvc.relpos_attention))
    unet = tvc.VideoCrafterUNet(CFG).eval()
    with torch.no_grad():
        unet(torch.zeros(1, 2, hw, hw, 4), torch.zeros(1), torch.zeros(1, 77, CFG.context_dim))
    assert seen == tvc.count_vc_kernel_sites(CFG, 2, hw, hw)
    assert seen["relpos_mha"] == 8


def test_full_vc_unet_parameter_count_matches_jax():
    jcfg = jvc.VideoCrafterUNetConfig()
    shapes = jax.eval_shape(jvc.VideoCrafterUNet(cfg=jcfg).init, jax.random.key(0),
                            jnp.zeros((1, 2, 8, 8, 4)), jnp.zeros((1,)),
                            jnp.zeros((1, 77, jcfg.context_dim)))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    with torch.device("meta"):
        unet = tvc.VideoCrafterUNet(VideoCrafterUNetConfig())
    assert sum(p.numel() for p in unet.parameters()) == n_jax
