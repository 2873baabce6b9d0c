"""The port's VideoCrafter path against the JAX package's at tiny size in
fp32: the CLIP-L text tower, the LVDM schedule and the DDIM plan and step,
the conditioning router, and the whole path (same weights and numpy starting
noise -> text encode -> 3 DDIM steps with CFG 9 -> VAE decode).

Tolerances: schedule and plan tables exactly (the same numpy code); one DDIM
step to 1e-6 (float32 elementwise math); tower and UNet outputs to
rtol = atol = 2e-4; final latents to 1e-3 absolute and relative (float32 on
both sides, another summation order, and CFG 9 amplifies the
conditional/unconditional difference ninefold); uint8 frames within one
level.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v.core.config import CLIPTextConfig as JClipCfg
from t2v.core.config import T2VArgs as JArgs
from t2v.core.config import VAEConfig as JVAECfg
from t2v.core.dtypes import Policy as JPolicy
from t2v.diffusion import ddim as jddim
from t2v.diffusion.sampling import sample_loop as j_sample_loop
from t2v.diffusion.schedules import DiffusionSchedule as JSchedule
from t2v.diffusion.schedules import beta_schedule as j_beta_schedule
from t2v.io.convert_vc import convert_vc_unet
from t2v.models import conditioning as jcond
from t2v.models.vae import AutoencoderKL as JVAE
from t2v.models.videocrafter_unet import VideoCrafterUNet as JUNet
from t2v.models.videocrafter_unet import VideoCrafterUNetConfig as JCfg
from t2v.pipeline.videocrafter import VideoCrafterPipeline as JPipeline
from t2v.text.clip import CLIPTextTransformer as JClip
from t2v.text.clip import convert_hf_clip_text
from t2v.text.tokenizer import CLIPTokenizer as JTokenizer
from t2v_torch.core.config import CLIPTextConfig, T2VArgs, VideoCrafterUNetConfig
from t2v_torch.core.dtypes import Policy
from t2v_torch.diffusion import ddim
from t2v_torch.diffusion.sampling import get_sampler
from t2v_torch.diffusion.schedules import DiffusionSchedule, beta_schedule
from t2v_torch.io import convert
from t2v_torch.models import conditioning as tcond
from t2v_torch.models.videocrafter_unet import VideoCrafterUNet
from t2v_torch.pipeline.pipeline import init_weights
from t2v_torch.pipeline.videocrafter import VideoCrafterPipeline
from t2v_torch.text.clip import HFCLIPTextModel

TOL = dict(rtol=2e-4, atol=2e-4)


def _lvdm(mod_schedule, mod_betas):
    return mod_schedule.from_betas(mod_betas("linear", 1000, 0.00085, 0.012))


@pytest.mark.parametrize("name,args", [("linear_sd", ()), ("linear", (0.00085, 0.012)),
                                       ("linear", ()), ("cosine", ()), ("sqrt_linear", ())])
def test_beta_schedules_match_jax(name, args):
    np.testing.assert_array_equal(beta_schedule(name, 50, *args), j_beta_schedule(name, 50, *args))
    with pytest.raises(ValueError):
        beta_schedule("nope")


@pytest.mark.parametrize("steps,eta", [(20, 0.0), (7, 0.5), (30, 1.0)])
def test_ddim_plan_matches_jax(steps, eta):
    mine, theirs = _lvdm(DiffusionSchedule, beta_schedule), _lvdm(JSchedule, j_beta_schedule)
    np.testing.assert_array_equal(mine.alphas_cumprod, theirs.alphas_cumprod)
    p, q = ddim.plan(mine, steps, eta), jddim.plan(theirs, steps, eta)
    assert p.steps == q.steps
    for f in ("timesteps", "alphas", "alphas_prev", "sqrt_one_minus_alphas", "sigmas"):
        np.testing.assert_array_equal(getattr(p, f), getattr(q, f))


@pytest.mark.parametrize("i,eta", [(0, 0.0), (5, 0.7), (19, 0.7)])
def test_ddim_step_matches_jax(i, eta):
    rng = np.random.default_rng(i)
    x, eps, noise = (rng.normal(size=(1, 3, 4, 4, 4)).astype(np.float32) for _ in range(3))
    p = ddim.plan(_lvdm(DiffusionSchedule, beta_schedule), 20, eta)
    q = jddim.plan(_lvdm(JSchedule, j_beta_schedule), 20, eta)
    want = np.asarray(jddim.step(jnp.asarray(x), jnp.asarray(eps), q, i, jnp.asarray(noise)))
    got = ddim.step(torch.from_numpy(x), torch.from_numpy(eps), p, i,
                    torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_ddim_is_registered_with_full_channel_cfg():
    assert get_sampler("DDIM") is ddim and ddim.CFG_COMBINE == jddim.CFG_COMBINE == "full"
    with pytest.raises(ValueError, match="not ported"):
        get_sampler("UniPC")


@pytest.mark.parametrize("key", ["crossattn", "concat", "hybrid", "adm", "crossattn-adm", None])
def test_conditioning_router_matches_jax(key):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 4, 4, 4)).astype(np.float32)
    ctx = rng.normal(size=(2, 7, 8)).astype(np.float32)
    cat = rng.normal(size=(2, 3, 4, 4, 2)).astype(np.float32)
    adm = rng.normal(size=(2, 16)).astype(np.float32)
    cond = {"c_crossattn": [ctx], "c_concat": [cat], "s": adm, "temporal_context": adm[:1]}
    assert tcond.CONDITIONING_KEYS == jcond.CONDITIONING_KEYS
    assert tcond.normalize_cond(key, [1]) == jcond.normalize_cond(key, [1])
    jx, jkw = jcond.route_conditioning(key, jnp.asarray(x), jax.tree.map(jnp.asarray, cond))
    tx, tkw = tcond.route_conditioning(key, torch.from_numpy(x),
                                       jax.tree.map(torch.from_numpy, cond))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert set(tkw) == set(jkw)
    for name, want in jkw.items():
        assert (tkw[name] is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(tkw[name].numpy(), np.asarray(want))
    with pytest.raises(NotImplementedError):
        tcond.route_conditioning("nope", torch.from_numpy(x), cond)


def _perturbed(tree, rng):
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + 0.02 * rng.normal(size=np.shape(a)).astype(np.float32),
        tree,
    )


def test_clip_l_tower_matches_jax():
    """The HF-layout tower (quick-GELU, last hidden state) on the JAX
    package's parameters, and its state dict back through the JAX package's
    ``convert_hf_clip_text``."""
    cfg = dataclasses.replace(CLIPTextConfig.clip_l_14(), width=64, layers=3, heads=4,
                              vocab_size=512)
    jcfg = JClipCfg(**dataclasses.asdict(cfg))
    assert dataclasses.asdict(CLIPTextConfig.clip_l_14()) == dataclasses.asdict(JClipCfg.clip_l_14())
    rng = np.random.default_rng(5)
    tower = HFCLIPTextModel(cfg).eval()
    init_weights(tower, 0)
    sd = {k: v.numpy() for k, v in tower.state_dict().items()}
    params = _perturbed(convert_hf_clip_text(sd, jcfg), rng)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, 77))
    want = np.asarray(JClip(cfg=jcfg).apply(params, jnp.asarray(tokens, jnp.int32)))
    back = convert.from_jax_clip(params, cfg, layout="hf")
    assert set(back) == set(sd)
    convert.load_into(tower, back)
    with torch.no_grad():
        got = tower(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    again = convert_hf_clip_text(back, jcfg)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(dict(jax.tree_util.tree_leaves_with_path(again))[path], leaf)


def _jax_pipeline(rng) -> JPipeline:
    """The JAX package's tiny fp32 VideoCrafter pipeline, as its
    ``random_init`` builds it, except that the UNet parameters come from a
    seeded port UNet through the JAX package's own converter (initialising
    the JAX UNet costs a long compile). Every leaf is perturbed, so that no
    zero-initialised gate or constant hides a layout bug."""
    policy, cfg, vcfg = JPolicy.fp32(), JCfg().tiny(), JVAECfg().tiny()
    tok = JTokenizer.for_tests()
    ccfg = dataclasses.replace(JClipCfg.clip_l_14(), width=cfg.context_dim, layers=2, heads=2,
                               vocab_size=tok.vocab_size)
    unet = VideoCrafterUNet(VideoCrafterUNetConfig().tiny())
    init_weights(unet, 0)
    unet_params = convert_vc_unet({k: v.numpy() for k, v in unet.state_dict().items()}, cfg)
    vae = JVAE(cfg=vcfg, policy=policy)
    vae_params = jax.jit(vae.init)(jax.random.key(1), jnp.zeros((1, 32, 32, 3)))
    clip = JClip(cfg=ccfg, policy=policy)
    clip_params = jax.jit(clip.init)(jax.random.key(2), jnp.zeros((1, 77), jnp.int32))
    return JPipeline(
        cfg=cfg, vae_cfg=vcfg, clip_cfg=ccfg, policy=policy, unet=JUNet(cfg=cfg, policy=policy),
        vae=vae, clip=clip,
        # device arrays: the rel-pos table is indexed inside the sampler's scan
        unet_params=jax.tree.map(jnp.asarray, _perturbed(unet_params, rng)),
        vae_params=_perturbed(vae_params, rng), clip_params=_perturbed(clip_params, rng),
        tokenizer=tok,
        schedule=JSchedule.from_betas(
            j_beta_schedule("linear", cfg.num_timesteps, cfg.linear_start, cfg.linear_end)),
    )


def test_tiny_vc_pipeline_end_to_end_matches_jax():
    rng = np.random.default_rng(0)
    jpipe = _jax_pipeline(rng)
    pipe = VideoCrafterPipeline.from_jax(jpipe.unet_params, jpipe.vae_params, jpipe.clip_params,
                                         VideoCrafterUNetConfig().tiny(), Policy.fp32(),
                                         device="cpu")
    assert dataclasses.asdict(pipe.clip_cfg) == dataclasses.asdict(jpipe.clip_cfg)
    fields = dict(prompt="a cat in the forest", n_prompt="blurry, text", steps=3, frames=4,
                  width=16, height=16, cfg_scale=9.0, seed=11, sampler="DDIM")
    noise = rng.normal(size=(1, 4, 8, 8, 4)).astype(np.float32)

    jargs = JArgs(**fields)
    cond, uncond = jpipe.encode_text([jargs.prompt]), jpipe.encode_text([jargs.n_prompt])
    np.testing.assert_allclose(pipe.encode_text([jargs.prompt]).numpy(), np.asarray(cond), **TOL)
    want_lat = j_sample_loop(
        jpipe.make_apply_fn(), jpipe.schedule, steps=3, shape=noise.shape, cond=cond,
        uncond=uncond, guidance_scale=9.0, sampler_name="DDIM", noise=jnp.asarray(noise),
    )
    want_frames = jpipe.decode_latents(want_lat[0])

    res = pipe.infer(T2VArgs(**fields), noise=torch.from_numpy(noise))
    assert res.frames.shape == (4, 16, 16, 3) and res.frames.dtype == np.uint8
    assert res.infotext == jpipe.create_infotext(jargs, 11)
    np.testing.assert_allclose(res.latents.numpy(), np.asarray(want_lat), rtol=1e-3, atol=1e-3)
    diff = res.frames.astype(np.float64) - want_frames.astype(np.float64)
    assert np.abs(diff).max() <= 1


def test_vc_seeded_noise_is_reproducible_on_the_cpu():
    pipe = VideoCrafterPipeline.random_init(VideoCrafterUNetConfig().tiny(), device="cpu", seed=3)
    args = T2VArgs(prompt="a dog", steps=1, frames=2, width=16, height=16, cfg_scale=9.0, seed=5)
    a, b = pipe.infer(args), pipe.infer(args)
    np.testing.assert_array_equal(a.latents.numpy(), b.latents.numpy())
    c = pipe.infer(args, batch_index=1)
    assert "Seed: 6" in c.infotext and "Model: VideoCrafter" in c.infotext
    # the zero-initialised head makes a fresh model's output 0, so the two
    # seeds differ only through their starting noise
    assert not np.array_equal(a.latents.numpy(), c.latents.numpy())


@pytest.mark.parametrize("kwargs", [
    dict(callback=lambda step: None, callback_interval=2), dict(sample_type="ddpm"),
    dict(sample_type="dpm++ 2m"), dict(features_adapter=(torch.zeros(1),)),
    dict(mask=torch.ones(1)), dict(uc_type="cfg_original"),
])
def test_vc_infer_names_the_branches_not_ported_yet(kwargs):
    pipe = VideoCrafterPipeline.random_init(VideoCrafterUNetConfig().tiny(), device="cpu")
    args = T2VArgs(prompt="a dog", steps=1, frames=2, width=16, height=16)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        pipe.infer(args, **kwargs)
