"""Two ModelScope request modes of the port's pipeline end to end against
the JAX package's ``ModelScopePipeline.infer``, on the same tiny fp32
weights, in float32 on the CPU:

* vid2vid with DDIM: source frames -> ``compute_latents`` -> re-noised at
  the strength over the skipped-step plan -> decode;
* img2vid progressive inpainting with DDIM_Gaussian:
  ``build_inpainting_inputs`` (keyframed mask weights, masked start) ->
  the loop that blends the re-noised source back in every step -> decode.

Each side's random draws are the JAX package's, handed to the port: the
starting latent from the request's key, the inpainting start from its
``inpaint_init`` stream and each step's blend noise from its
``inpaint_noise`` stream. Tolerances as in ``test_torch_pipeline.py``:
latents to 1e-3 absolute and relative (CFG 9 amplifies float32 summation
order), uint8 frames within one level.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v.core import rng as jrng
from t2v.core.config import CLIPTextConfig as JClipCfg
from t2v.core.config import ModelScopeUNetConfig as JCfg
from t2v.core.config import T2VArgs as JArgs
from t2v.core.config import VAEConfig as JVAECfg
from t2v.core.dtypes import Policy as JPolicy
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
from t2v_torch.models.modelscope_unet import UNetSD
from t2v_torch.pipeline.pipeline import ModelScopePipeline, init_weights
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

FIELDS = dict(prompt="a (cat:1.2) in the forest", n_prompt="blurry, text", steps=4, frames=3,
              width=16, height=16, cfg_scale=9.0, seed=11)
TOL = dict(rtol=1e-3, atol=1e-3)


def _perturbed(tree, rng):
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + 0.02 * rng.normal(size=np.shape(a)).astype(np.float32),
        tree,
    )


@pytest.fixture(scope="module")
def pipelines():
    """The JAX package's tiny fp32 pipeline (UNet weights from a seeded port
    UNet through the JAX converter, every leaf perturbed so that no zero gate
    hides a layout bug) and the port's pipeline on the same weights."""
    rng = np.random.default_rng(0)
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
    jpipe = JPipeline(
        unet_cfg=ucfg, vae_cfg=vcfg, clip_cfg=ccfg, policy=policy,
        unet=JUNet(cfg=ucfg, policy=policy), vae=vae,
        unet_params=_perturbed(unet_params, rng), vae_params=_perturbed(vae_params, rng),
        text_encoder=JTextEncoder(clip, _perturbed(clip_params, rng), tok),
        schedule=JSchedule.linear_sd(ucfg.num_timesteps),
    )
    pipe = ModelScopePipeline.from_jax(
        jpipe.unet_params, jpipe.vae_params, jpipe.text_encoder.params,
        ModelScopeUNetConfig().tiny(), Policy.fp32(), device="cpu",
    )
    return jpipe, pipe


def _latent_noise(args, shape):
    return torch.from_numpy(np.array(jrng.latent_noise(jrng.key_for_seed(args.seed), shape)))


def _check(res, want):
    np.testing.assert_allclose(res.latents.numpy(), np.asarray(want.latents), **TOL)
    frames = np.stack(want.frames)
    assert res.frames.shape == frames.shape and res.frames.dtype == np.uint8
    assert np.abs(res.frames.astype(np.int64) - frames.astype(np.int64)).max() <= 1


def test_vid2vid_ddim_matches_jax(pipelines):
    jpipe, pipe = pipelines
    src = np.random.default_rng(5).uniform(-1.0, 1.0, (3, 16, 16, 3)).astype(np.float32)
    jlat = jpipe.compute_latents(src)
    lat = pipe.compute_latents(src)
    np.testing.assert_allclose(lat.numpy(), np.asarray(jlat), rtol=1e-4, atol=1e-4)
    fields = dict(FIELDS, sampler="DDIM", strength=0.5)
    skip = 1
    want = jpipe.infer(JArgs(**fields), latents=jlat, is_vid2vid=True, skip_steps=skip)
    args = T2VArgs(**fields)
    res = pipe.infer(args, latents=lat, is_vid2vid=True, skip_steps=skip,
                     noise=_latent_noise(args, tuple(lat.shape)))
    _check(res, want)


def test_progressive_inpainting_matches_jax(pipelines):
    jpipe, pipe = pipelines
    img = np.random.default_rng(6).integers(0, 256, (16, 16, 3)).astype(np.uint8)
    fields = dict(FIELDS, inpainting_frames=2)
    jargs, args = JArgs(**fields), T2VArgs(**fields)
    key = jrng.key_for_seed(args.seed)
    jmasked, jmask, jimg = jpipe.build_inpainting_inputs(img, jargs, key)
    init = np.array(jax.random.normal(jrng.stream(key, "inpaint_init"), jmask.shape))
    masked, mask, img_lat = pipe.build_inpainting_inputs(img, args, noise=torch.from_numpy(init))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(img_lat.numpy(), np.asarray(jimg), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(masked.numpy(), np.asarray(jmasked), rtol=1e-4, atol=1e-4)

    want = jpipe.infer(jargs, latents=jmasked, mask=jmask, image_latents=jimg,
                       inpaint_mode="progressive")
    blend_key = jrng.stream(key, "inpaint_noise")
    blend = [torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(blend_key, i),
                                                         jmask.shape, jnp.float32)))
             for i in range(args.steps)]
    res = pipe.infer(args, latents=masked, mask=mask, image_latents=img_lat,
                     inpaint_mode="progressive", noise=_latent_noise(args, tuple(mask.shape)),
                     inpaint_noise=blend)
    _check(res, want)
