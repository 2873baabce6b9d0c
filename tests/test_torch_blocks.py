"""The port's UNet building blocks against ``t2v.models.blocks`` in fp32:
the JAX module is initialised, every parameter is perturbed (so
zero-initialised gates carry signal and no layout bug hides behind a
constant), the tree is converted with the port's converter, and both run
the same numpy input.

Tolerance: 1e-4 absolute and relative. Both sides compute in float32, in
another summation order (XLA's convolutions and einsums against torch's);
across a block's GroupNorms, convolutions and attention the difference
stays below 1e-5 of O(1) activations, so 1e-4 leaves a margin of ten.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v.models import blocks as JB
from t2v_torch.io import convert
from t2v_torch.models import blocks as TB
from t2v_torch.models.modelscope_unet import BlockDesc
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)


def _init(mod, *args):
    params = mod.init(jax.random.key(0), *args)["params"]
    rng = np.random.default_rng(1)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + 0.05 * rng.normal(size=np.shape(a)).astype(np.float32),
        params,
    )


def _load(module, sd, prefix=""):
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    convert.load_into(module, sd)
    return module.eval()


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _run(module, *args, **kw):
    with torch.no_grad():
        return module(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args],
                      **kw).numpy()


def test_sinusoidal_embedding():
    t = np.array([0.0, 1.0, 500.0, 999.0], np.float32)
    for dim in (320, 33):
        want = np.asarray(JB.sinusoidal_embedding(jnp.asarray(t), dim))
        got = TB.sinusoidal_embedding(torch.from_numpy(t), dim).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("eps,silu", [(1e-5, True), (1e-6, False)])
def test_group_norm32(eps, silu):
    x = _x(0, 2, 3, 4, 64) * 3 + 1
    p = _init(JB.GroupNorm32(eps=eps, fuse_silu=silu), jnp.asarray(x))
    want = np.asarray(JB.GroupNorm32(eps=eps, fuse_silu=silu).apply({"params": p}, jnp.asarray(x)))
    sd = {}
    convert._gn32(sd, "n", p)
    got = _run(_load(TB.GroupNorm32(64, eps, silu), sd, "n."), x)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("context_len", [None, 77])
def test_cross_attention(context_len):
    x = _x(1, 3, 16, 32)
    ctx = None if context_len is None else _x(2, 3, context_len, 24)
    jmod = JB.CrossAttention(query_dim=32, context_dim=None if ctx is None else 24, heads=2, dim_head=16)
    args = (jnp.asarray(x),) if ctx is None else (jnp.asarray(x), jnp.asarray(ctx))
    p = _init(jmod, *args)
    want = np.asarray(jmod.apply({"params": p}, *args))
    sd = {}
    for proj in ("to_q", "to_k", "to_v"):
        convert._linear(sd, proj, p[proj])
    convert._linear(sd, "to_out.0", p["to_out"])
    tmod = _load(TB.CrossAttention(32, None if ctx is None else 24, 2, 16), sd)
    got = _run(tmod, x, context=None if ctx is None else torch.from_numpy(ctx))
    np.testing.assert_allclose(got, want, **TOL)


def test_geglu_feed_forward():
    x = _x(3, 2, 10, 32)
    p = _init(JB.GEGLUFeedForward(dim=32), jnp.asarray(x))
    want = np.asarray(JB.GEGLUFeedForward(dim=32).apply({"params": p}, jnp.asarray(x)))
    sd = {}
    convert._linear(sd, "net.0.proj", p["geglu"])
    convert._linear(sd, "net.2", p["out"])
    got = _run(_load(TB.GEGLUFeedForward(32), sd), x)
    np.testing.assert_allclose(got, want, **TOL)


def test_basic_transformer_block():
    x, ctx = _x(4, 3, 16, 32), _x(5, 3, 77, 24)
    jmod = JB.BasicTransformerBlock(dim=32, heads=2, dim_head=16, context_dim=24)
    p = _init(jmod, jnp.asarray(x), jnp.asarray(ctx))
    want = np.asarray(jmod.apply({"params": p}, jnp.asarray(x), jnp.asarray(ctx)))
    sd = {}
    convert._basic_transformer_block(sd, "b", p)
    got = _run(_load(TB.BasicTransformerBlock(32, 2, 16, 24), sd, "b."), x,
               context=torch.from_numpy(ctx))
    np.testing.assert_allclose(got, want, **TOL)


def test_spatial_transformer():
    x, ctx = _x(6, 4, 4, 4, 64), _x(7, 4, 77, 24)
    jmod = JB.SpatialTransformer(channels=64, heads=4, dim_head=16, context_dim=24)
    p = _init(jmod, jnp.asarray(x), jnp.asarray(ctx))
    want = np.asarray(jmod.apply({"params": p}, jnp.asarray(x), jnp.asarray(ctx)))
    sd = {}
    convert._block(sd, BlockDesc("spatial", "", "m", 64, 64), p)
    got = _run(_load(TB.SpatialTransformer(64, 4, 16, 24), sd, "m."), x,
               context=torch.from_numpy(ctx))
    np.testing.assert_allclose(got, want, **TOL)


def test_temporal_transformer():
    x = _x(8, 2, 5, 3, 3, 64)
    jmod = JB.TemporalTransformer(channels=64, heads=2, dim_head=32)
    p = _init(jmod, jnp.asarray(x))
    want = np.asarray(jmod.apply({"params": p}, jnp.asarray(x)))
    sd = {}
    convert._block(sd, BlockDesc("temporal", "", "m", 64, 64), p)
    got = _run(_load(TB.TemporalTransformer(64, 2, 32), sd, "m."), x)
    np.testing.assert_allclose(got, want, **TOL)


def test_temporal_conv_block():
    x = _x(9, 2, 5, 3, 4, 64)
    jmod = JB.TemporalConvBlock(channels=64)
    p = _init(jmod, jnp.asarray(x))
    want = np.asarray(jmod.apply({"params": p}, jnp.asarray(x)))
    sd = {}
    for i in range(1, 5):
        convert._gn32(sd, f"conv{i}.0", p[f"norm{i}"])
        convert._conv3d(sd, f"conv{i}.{2 if i == 1 else 3}", p[f"conv{i}"])
    got = _run(_load(TB.TemporalConvBlock(64), sd), x)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("cin,cout", [(64, 64), (96, 64)])
def test_res_block(cin, cout):
    frames = 3
    x, emb = _x(10, 2 * frames, 4, 4, cin), _x(11, 2 * frames, 128)
    jmod = JB.ResBlock(channels=cin, emb_channels=128, out_channels=cout, frames=frames)
    p = _init(jmod, jnp.asarray(x), jnp.asarray(emb))
    want = np.asarray(jmod.apply({"params": p}, jnp.asarray(x), jnp.asarray(emb)))
    sd = {}
    convert._block(sd, BlockDesc("res", "", "m", cin, cout), p)
    got = _run(_load(TB.ResBlock(cin, 128, cout), sd, "m."), x, torch.from_numpy(emb), frames)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kind", ["upsample", "downsample"])
def test_resample(kind):
    x = _x(12, 3, 6, 6, 32)
    jcls, tcls = (JB.Upsample, TB.Upsample) if kind == "upsample" else (JB.Downsample, TB.Downsample)
    p = _init(jcls(channels=32), jnp.asarray(x))
    want = np.asarray(jcls(channels=32).apply({"params": p}, jnp.asarray(x)))
    sd = {}
    convert._block(sd, BlockDesc(kind, "", "m", 32, 32), p)
    got = _run(_load(tcls(32), sd, "m."), x)
    np.testing.assert_allclose(got, want, **TOL)
