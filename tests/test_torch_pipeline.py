"""The port's sampler and pipeline against the JAX package's, and the whole
slice at tiny size: the same weights and numpy starting noise -> text
encode -> 3 DDIM_Gaussian steps with CFG 9 -> VAE decode, in fp32.

Tolerances: schedule tables exactly (the same float64 numpy code);
one DDIM step to 1e-6 (float32 elementwise math); final latents to 1e-3
absolute and relative (float32 on both sides, another summation order,
and CFG 9 amplifies the conditional/unconditional difference ninefold);
uint8 frames within one level, and above 35 dB PSNR (BASELINE.md:20).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v.core.config import CLIPTextConfig as JClipCfg
from t2v.core.config import ModelScopeUNetConfig as JCfg
from t2v.core.config import T2VArgs as JArgs
from t2v.core.config import VAEConfig as JVAECfg
from t2v.core.dtypes import Policy as JPolicy
from t2v.diffusion import ddim_gaussian as jddim
from t2v.diffusion.sampling import cfg_combine as j_cfg_combine
from t2v.diffusion.sampling import sample_loop as j_sample_loop
from t2v.diffusion.schedules import DiffusionSchedule as JSchedule
from t2v.io.convert import convert_unet
from t2v.models.modelscope_unet import UNetSD as JUNet
from t2v.models.vae import AutoencoderKL as JVAE
from t2v.pipeline.pipeline import ModelScopePipeline as JPipeline
from t2v.text.clip import CLIPTextTransformer as JClip
from t2v.text.encoder import TextEncoder as JTextEncoder
from t2v.text.tokenizer import CLIPTokenizer as JTokenizer
from t2v_torch.core.config import ModelScopeUNetConfig, T2VArgs
from t2v_torch.core.dtypes import Policy
from t2v_torch.diffusion import ddim_gaussian
from t2v_torch.diffusion.sampling import cfg_combine
from t2v_torch.diffusion.schedules import DiffusionSchedule
from t2v_torch.models.modelscope_unet import UNetSD
from t2v_torch.pipeline.pipeline import ModelScopePipeline, init_weights
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_schedule_and_plan_match_jax():
    mine, theirs = DiffusionSchedule.linear_sd(), JSchedule.linear_sd()
    for name in ("alphas_cumprod", "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod"):
        np.testing.assert_array_equal(getattr(mine, name), getattr(theirs, name))
    for steps, eta in ((20, 0.0), (7, 0.5)):
        p, q = ddim_gaussian.plan(mine, steps, eta), jddim.plan(theirs, steps, eta)
        for f in ("timesteps", "alphas", "alphas_prev", "sigmas",
                  "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod"):
            np.testing.assert_array_equal(getattr(p, f), getattr(q, f))


@pytest.mark.parametrize("i,eta", [(0, 0.0), (5, 0.7), (19, 0.7)])
def test_ddim_step_matches_jax(i, eta):
    rng = np.random.default_rng(i)
    x, eps, noise = (rng.normal(size=(1, 3, 4, 4, 4)).astype(np.float32) for _ in range(3))
    p, q = ddim_gaussian.plan(DiffusionSchedule.linear_sd(), 20, eta), jddim.plan(JSchedule.linear_sd(), 20, eta)
    want = np.asarray(jddim.step(jnp.asarray(x), jnp.asarray(eps), q, i, jnp.asarray(noise)))
    got = ddim_gaussian.step(torch.from_numpy(x), torch.from_numpy(eps), p, i,
                             torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["full", "split_learned_range"])
def test_cfg_combine_matches_jax(mode):
    rng = np.random.default_rng(3)
    y, u = (rng.normal(size=(1, 2, 4, 4, 8)).astype(np.float32) for _ in range(2))
    want = np.asarray(j_cfg_combine(jnp.asarray(y), jnp.asarray(u), 9.0, mode))
    got = cfg_combine(torch.from_numpy(y), torch.from_numpy(u), 9.0, mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _perturbed(tree, rng):
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + 0.02 * rng.normal(size=np.shape(a)).astype(np.float32),
        tree,
    )


def _jax_pipeline(rng) -> JPipeline:
    """The JAX package's tiny fp32 pipeline, as its ``random_init`` builds
    it, except that the UNet parameters come from a seeded port UNet through
    the JAX package's own converter (initialising the JAX UNet costs a 22 s
    compile). Every leaf is perturbed, so that no zero-initialised gate or
    constant hides a layout bug."""
    policy, ucfg, vcfg = JPolicy.fp32(), JCfg().tiny(), JVAECfg().tiny()
    tok = JTokenizer.for_tests()
    ccfg = dataclasses.replace(JClipCfg.vit_h_14().tiny(), width=ucfg.context_dim,
                               vocab_size=tok.vocab_size)
    unet = UNetSD(ModelScopeUNetConfig().tiny())
    init_weights(unet, 0)
    unet_params = convert_unet({k: v.numpy() for k, v in unet.state_dict().items()}, ucfg)
    vae = JVAE(cfg=vcfg, policy=policy)
    vae_params = jax.jit(vae.init)(jax.random.key(1), jnp.zeros((1, 32, 32, 3)))
    clip = JClip(cfg=ccfg, policy=policy)
    clip_params = jax.jit(clip.init)(jax.random.key(2), jnp.zeros((1, 77), jnp.int32))
    return JPipeline(
        unet_cfg=ucfg, vae_cfg=vcfg, clip_cfg=ccfg, policy=policy,
        unet=JUNet(cfg=ucfg, policy=policy), vae=vae,
        unet_params=_perturbed(unet_params, rng), vae_params=_perturbed(vae_params, rng),
        text_encoder=JTextEncoder(clip, _perturbed(clip_params, rng), tok),
        schedule=JSchedule.linear_sd(ucfg.num_timesteps),
    )


def test_tiny_slice_end_to_end_matches_jax():
    rng = np.random.default_rng(0)
    jpipe = _jax_pipeline(rng)
    pipe = ModelScopePipeline.from_jax(
        jpipe.unet_params, jpipe.vae_params, jpipe.text_encoder.params,
        ModelScopeUNetConfig().tiny(), Policy.fp32(), device="cpu",
    )
    fields = dict(prompt="a (cat:1.2) in the forest", n_prompt="blurry, text", steps=3,
                  frames=3, width=16, height=16, cfg_scale=9.0, seed=11)
    noise = rng.normal(size=(1, 3, 8, 8, 4)).astype(np.float32)

    jargs = JArgs(**fields)
    cond = jpipe.text_encoder.encode_request(jargs.prompt, jargs.n_prompt, jargs.steps)
    unet = jpipe.unet
    want_lat = j_sample_loop(
        lambda x, t, c: unet.apply(jpipe.unet_params, x, t, c), jpipe.schedule,
        steps=3, shape=noise.shape, cond=cond.cond, uncond=cond.uncond, guidance_scale=9.0,
        sampler_name="DDIM_Gaussian", noise=jnp.asarray(noise),
    )
    want_frames = jpipe.decode_latents(want_lat[0])

    res = pipe.infer(T2VArgs(**fields), noise=torch.from_numpy(noise))
    assert res.frames.shape == (3, 16, 16, 3) and res.frames.dtype == np.uint8
    assert res.infotext == jpipe.create_infotext(jargs, 11)
    np.testing.assert_allclose(res.latents.numpy(), np.asarray(want_lat), rtol=1e-3, atol=1e-3)
    diff = res.frames.astype(np.float64) - want_frames.astype(np.float64)
    assert np.abs(diff).max() <= 1
    mse = max(float((diff ** 2).mean()), 1e-12)
    assert 10 * np.log10(255.0 ** 2 / mse) > 35.0


def test_seeded_noise_is_reproducible_on_the_cpu():
    pipe = ModelScopePipeline.random_init(device="cpu", seed=3)
    args = T2VArgs(prompt="a dog", steps=1, frames=2, width=16, height=16, cfg_scale=9.0, seed=5)
    a, b = pipe.infer(args), pipe.infer(args)
    np.testing.assert_array_equal(a.latents.numpy(), b.latents.numpy())
    c = pipe.infer(args, batch_index=1)
    assert "Seed: 6" in c.infotext
    assert not np.array_equal(a.latents.numpy(), c.latents.numpy())
