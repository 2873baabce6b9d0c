"""DeepCache in the port against the JAX package, in float32 on the CPU:

* the UNet's hooks at the tiny config: a full call with ``return_deep``
  (output and deep feature) and a cached call fed that feature, against the
  JAX ``UNetSD`` on the same weights (one jitted JAX program for both);
* the kernel-site count of a cached (shallow) call against the dispatch
  calls it makes;
* the DeepCache loop on a toy (full, cached) model pair against
  ``sample_loop_deepcache`` of the JAX package, fed the noise the JAX loop
  draws from its key, for the four samplers DeepCache supports;
* the pipeline: interval 1 is the exact request, interval 2 calls the
  shallow UNet on every other step.

Tolerances: the UNet to 2e-4 absolute and relative, as in
``test_torch_unet.py``; the toy loop to 2e-5 (float32 elementwise math).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v.core import rng as jrng
from t2v.core.config import ModelScopeUNetConfig as JCfg
from t2v.diffusion import deepcache as jdc
from t2v.diffusion.schedules import DiffusionSchedule as JSchedule
from t2v.io.convert import convert_unet
from t2v.models.modelscope_unet import UNetSD as JUNet
from t2v_torch.core.config import ModelScopeUNetConfig, T2VArgs
from t2v_torch.diffusion import deepcache as tdc
from t2v_torch.diffusion.schedules import DiffusionSchedule
from t2v_torch.models import blocks as TB
from t2v_torch.models.modelscope_unet import UNetSD, count_kernel_sites
from t2v_torch.pipeline.pipeline import ModelScopePipeline, init_weights
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = ModelScopeUNetConfig().tiny()


@pytest.fixture(scope="module")
def unet():
    """A seeded tiny UNet with every leaf perturbed (no zero gate hides a
    layout bug), and its JAX parameter tree."""
    unet = UNetSD(CFG).eval()
    init_weights(unet, 0)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p in unet.parameters():
            p.add_(torch.from_numpy(0.02 * rng.normal(size=tuple(p.shape)).astype(np.float32)))
    return unet, convert_unet({k: v.numpy() for k, v in unet.state_dict().items()}, JCfg().tiny())


def test_deepcache_hooks_match_jax(unet):
    unet, jparams = unet
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 8, 8, 4)).astype(np.float32)
    x2 = rng.normal(size=(2, 3, 8, 8, 4)).astype(np.float32)
    t = np.array([981.0, 501.0], np.float32)
    ctx = rng.normal(size=(2, 7, CFG.context_dim)).astype(np.float32)
    model = JUNet(cfg=JCfg().tiny())

    def both(params, x, x2, t, ctx):
        out, deep = model.apply(params, x, t, ctx, return_deep=True)
        return out, deep, model.apply(params, x2, t - 20.0, ctx, deep_feature=deep)

    want_out, want_deep, want_cached = jax.jit(both)(
        jparams, *map(jnp.asarray, (x, x2, t, ctx)))
    tx, tx2, tt, tctx = map(torch.from_numpy, (x, x2, t, ctx))
    with torch.no_grad():
        out, deep = unet(tx, tt, tctx, return_deep=True)
        cached = unet(tx2, tt - 20.0, tctx, deep_feature=deep)
        plain = unet(tx, tt, tctx)
    np.testing.assert_array_equal(out.numpy(), plain.numpy())
    for got, want in ((out, want_out), (deep, want_deep), (cached, want_cached)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_cached_kernel_sites_match_the_dispatch_calls(monkeypatch, unet):
    unet = unet[0]
    seen = {"temporal_conv": 0, "flash_attention": 0, "fused_self_mha": 0}
    real_attn, real_chain = TB.self_attention_packed, TB.temporal_conv_chain

    def attn(q, k, v, heads, scale=None):
        seen["fused_self_mha" if q.shape[1] < 512 else "flash_attention"] += 1
        return real_attn(q, k, v, heads, scale)

    def chain(x, layers, eps=1e-5):
        seen["temporal_conv"] += len(layers)
        return real_chain(x, layers, eps)

    x = torch.zeros(1, 3, 32, 32, 4)
    t, ctx = torch.zeros(1), torch.zeros(1, 7, CFG.context_dim)
    with torch.no_grad():
        _, deep = unet(x, t, ctx, return_deep=True)
        monkeypatch.setattr(TB, "self_attention_packed", attn)
        monkeypatch.setattr(TB, "temporal_conv_chain", chain)
        unet(x, t, ctx, deep_feature=deep)
    want = count_kernel_sites(CFG, 3, 32, 32, cached=True)
    assert seen == want and want["flash_attention"] == 1
    full = count_kernel_sites(CFG, 3, 32, 32)
    assert all(want[k] < full[k] for k in full)


def _toy_pair(lib, mean):
    """A toy (full, cached) model pair in jax.numpy or torch: the full call
    returns (output, deep feature), the cached call takes that feature."""
    def cached(x, t, ctx, feat):
        return 0.3 * x + feat + 0.2 * mean(ctx)[:, None, None, None, None]

    def full(x, t, ctx):
        feat = lib.tanh(x) + 1e-3 * t[:, None, None, None, None]
        return cached(x, t, ctx, feat), 0.5 * feat

    return full, cached


@pytest.mark.parametrize("name,eta,interval", [("DDIM_Gaussian", 0.0, 2), ("DDIM", 0.5, 3),
                                               ("Euler", 0.0, 2), ("Euler a", 0.0, 3)])
def test_deepcache_loop_matches_jax(name, eta, interval):
    shape = (1, 3, 4, 4, 4)
    rng = np.random.default_rng(4)
    cond, uncond = (rng.normal(size=(1, 5, 8)).astype(np.float32) for _ in range(2))
    key = jrng.key_for_seed(9)
    steps = 10
    want = jdc.sample_loop_deepcache(
        *_toy_pair(jnp, lambda c: c.mean(axis=(1, 2))), JSchedule.linear_sd(), steps=steps,
        shape=shape, cond=jnp.asarray(cond), uncond=jnp.asarray(uncond), guidance_scale=3.0,
        eta=eta, sampler_name=name, key=key, interval=interval)
    start = torch.from_numpy(np.array(jrng.latent_noise(key, shape)))
    eta_key = jrng.stream(key, "ddim_eta")
    step_noise = [torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(eta_key, i),
                                                              shape, jnp.float32)))
                  for i in range(steps)]
    full, cached = _toy_pair(torch, lambda c: c.mean(dim=(1, 2)))
    calls = []
    got = tdc.sample_loop_deepcache(
        lambda *a: (calls.append("full"), full(*a))[1],
        lambda *a: (calls.append("cached"), cached(*a))[1], DiffusionSchedule.linear_sd(),
        steps=steps, shape=shape, cond=torch.from_numpy(cond), uncond=torch.from_numpy(uncond),
        guidance_scale=3.0, eta=eta, sampler_name=name, noise=start, step_noise=step_noise,
        interval=interval)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    assert calls == ["full" if i % interval == 0 else "cached" for i in range(steps)]


def test_deepcache_refuses_multistep_samplers():
    with pytest.raises(ValueError, match="deepcache supports"):
        tdc.deepcache_plan("UniPC", DiffusionSchedule.linear_sd(), 10, 0.0)


def test_pipeline_deepcache_interval_one_is_exact_and_two_caches(monkeypatch):
    pipe = ModelScopePipeline.random_init(device="cpu", seed=3)
    args = T2VArgs(prompt="a dog", steps=4, frames=2, width=16, height=16, cfg_scale=9.0, seed=5)
    exact = pipe.infer(args)
    same = pipe.infer(args, deep_cache_interval=1)
    np.testing.assert_array_equal(exact.latents.numpy(), same.latents.numpy())
    kinds = []
    real = UNetSD.forward

    def spy(self, x, t, context, **kw):
        kinds.append("cached" if kw.get("deep_feature") is not None else
                      "full" if kw.get("return_deep") else "plain")
        return real(self, x, t, context, **kw)

    monkeypatch.setattr(UNetSD, "forward", spy)
    cached = pipe.infer(args, deep_cache_interval=2)
    assert kinds == ["full", "cached", "full", "cached"]
    assert torch.isfinite(cached.latents).all() and cached.frames.shape == exact.frames.shape
