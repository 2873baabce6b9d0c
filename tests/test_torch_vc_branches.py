"""VideoCrafter's other branches in the port against the JAX package's, at
tiny size in float32 on the CPU: the full-chain DDPM sampler, each branch of
``VideoCrafterPipeline.infer`` (the ``uc_type`` CFG variants, LVDM's static
mask, DPM++ 2M whole and windowed, the DDPM chain, FPS conditioning with
T2I-Adapter features), the FPS embedder and its checkpoint loading, the
UNet's ``label_proj``, masked temporal attention, and ``run`` and the CLI
with each new flag.

Each side draws its randomness from the JAX package's own streams: the
starting latent from the request's key, LVDM's blend noise from its
``inpaint_noise`` stream and the DDPM chain's from ``ddpm_noise``, handed to
the port as ``noise``, ``inpaint_noise[i]`` and ``ddpm_noise[i]``.
Tolerances: the DDPM step math to 1e-5; modules to 1e-5 (of the output's
largest magnitude); final latents to 1e-3 absolute and relative (float32 on
both sides in another summation order, and CFG 9 amplifies the
conditional/unconditional difference ninefold); uint8 frames within one
level; a windowed request bit-identical to the whole one.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v.core import rng as jrng
from t2v.core.config import T2VArgs as JArgs
from t2v.diffusion import ddpm as jddpm
from t2v.diffusion.schedules import DiffusionSchedule as JSchedule
from t2v.diffusion.schedules import beta_schedule as j_beta_schedule
from t2v.io.convert_vc import convert_fps_embedder, convert_vc_unet
from t2v.models import videocrafter_unet as jvc
from t2v.models.adapter import Adapter as JAdapter
from t2v.models.adapter import convert_adapter
from t2v_torch.core.config import T2VArgs, VideoCrafterUNetConfig
from t2v_torch.core.dtypes import Policy
from t2v_torch.diffusion import ddpm
from t2v_torch.diffusion.schedules import DiffusionSchedule, beta_schedule
from t2v_torch.io.convert_vc import fps_embedder_state, lightning_state_dict
from t2v_torch.models import videocrafter_unet as tvc
from t2v_torch.models.adapter import Adapter, AdapterConfig
from t2v_torch.pipeline.pipeline import init_weights
from t2v_torch.pipeline.videocrafter import VideoCrafterPipeline
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_vc_pipeline import _jax_pipeline, _perturbed

TOL = dict(rtol=1e-3, atol=1e-3)
FIELDS = dict(prompt="a cat in the forest", n_prompt="blurry, text", steps=4, frames=4,
              width=16, height=16, cfg_scale=9.0, seed=11, sampler="DDIM")
FPS_CFG = dataclasses.replace(VideoCrafterUNetConfig().tiny(), cond_stage2_key="temporal_context")


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1.0)


def _jax_draws(stream: str, seed: int, n: int, shape) -> list[torch.Tensor]:
    key = jrng.stream(jrng.key_for_seed(seed), stream)
    return [torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, i), shape,
                                                        jnp.float32))) for i in range(n)]


def _start(seed: int, shape) -> torch.Tensor:
    return torch.from_numpy(np.array(jrng.latent_noise(jrng.key_for_seed(seed), shape)))


def _check(res, want):
    np.testing.assert_allclose(res.latents.numpy(), np.asarray(want.latents), **TOL)
    frames = np.stack(want.frames)
    assert res.frames.shape == frames.shape and res.frames.dtype == np.uint8
    assert np.abs(res.frames.astype(np.int64) - frames.astype(np.int64)).max() <= 1


def test_ddpm_matches_jax_on_a_toy_model():
    """The posterior tables equal the JAX package's, and the whole chain
    (T = 40, with and without the x0 clip) matches it on a toy eps model fed
    the JAX chain's own noise."""
    betas = beta_schedule("linear", 40, 0.00085, 0.012)
    mine, theirs = DiffusionSchedule.from_betas(betas), JSchedule.from_betas(betas)
    for name in ("posterior_mean_coef1", "posterior_mean_coef2",
                 "posterior_log_variance_clipped", "sqrt_recip_alphas_cumprod",
                 "sqrt_recipm1_alphas_cumprod"):
        np.testing.assert_array_equal(getattr(mine, name), getattr(theirs, name))
    shape = (1, 2, 4, 4, 4)
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    key = jrng.key_for_seed(3)
    table = _jax_draws("ddpm_noise", 3, 40, shape)
    for clip in (True, False):
        want = jddpm.sample(lambda z, t, i: 0.3 * z + 0.01 * jnp.cos(t), theirs, jnp.asarray(x),
                            key, clip_denoised=clip)
        got = ddpm.sample(lambda z, t, i: 0.3 * z + 0.01 * np.cos(t), mine, torch.from_numpy(x),
                          noise_table=table, clip_denoised=clip)
        _close(got.numpy(), np.asarray(want))
    # seeded draws: reproducible, and the last step adds no noise
    a = ddpm.sample(lambda z, t, i: 0 * z, mine, torch.from_numpy(x),
                    generator=torch.Generator().manual_seed(1))
    b = ddpm.sample(lambda z, t, i: 0 * z, mine, torch.from_numpy(x),
                    generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.fixture(scope="module")
def pipelines():
    """The JAX package's tiny fp32 pipeline and the port's on the same
    weights."""
    jpipe = _jax_pipeline(np.random.default_rng(0))
    pipe = VideoCrafterPipeline.from_jax(jpipe.unet_params, jpipe.vae_params, jpipe.clip_params,
                                         VideoCrafterUNetConfig().tiny(), Policy.fp32(),
                                         device="cpu")
    return jpipe, pipe


def test_uc_type_and_lvdm_mask_match_jax(pipelines):
    """DDIM with ``cfg_ours`` over LVDM's static mask from
    ``build_inpainting_inputs``; the windowed request equals the whole one
    bit for bit; ``cfg_original`` and ``cfg_ours`` differ."""
    jpipe, pipe = pipelines
    fields = dict(FIELDS, inpainting_frames=2)
    jargs, args = JArgs(**fields), T2VArgs(**fields)
    img = np.random.default_rng(6).integers(0, 256, (16, 16, 3)).astype(np.uint8)
    jmask, jsrc = jpipe.build_inpainting_inputs(img, jargs)
    mask, src = pipe.build_inpainting_inputs(img, args)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(src.numpy(), np.asarray(jsrc), rtol=1e-4, atol=1e-4)
    assert mask[0, :, 0, 0, 0].tolist() == [1.0, 0.0, 0.0, 0.0]

    want = jpipe.infer(jargs, mask=jmask, source_latents=jsrc, uc_type="cfg_ours")
    shape = tuple(mask.shape)
    kw = dict(mask=mask, source_latents=src, uc_type="cfg_ours", noise=_start(11, shape),
              inpaint_noise=_jax_draws("inpaint_noise", 11, 4, shape))
    res = pipe.infer(args, **kw)
    _check(res, want)
    # the kept frame is the source re-noised to t = 0 by the last step's
    # blend, sqrt(abar_0)·source + sqrt(1 - abar_0)·noise, on both sides
    sa, s1ma = (float(getattr(pipe.schedule, n)[0])
                for n in ("sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod"))
    kept = sa * src[0, 0] + s1ma * kw["inpaint_noise"][-1][0, 0]
    for lat in (res.latents.numpy(), np.asarray(want.latents)):
        np.testing.assert_allclose(lat[0, 0], kept.numpy(), rtol=1e-6, atol=1e-6)
    done = []
    windowed = pipe.infer(args, callback=done.append, callback_interval=2, **kw)
    assert done == [2, 4]
    np.testing.assert_array_equal(windowed.latents.numpy(), res.latents.numpy())
    other = pipe.infer(args, **dict(kw, uc_type="cfg_original"))
    assert not np.array_equal(other.latents.numpy(), res.latents.numpy())


def test_dpmpp_2m_whole_and_windowed_match_jax(pipelines):
    jpipe, pipe = pipelines
    want = jpipe.infer(JArgs(**FIELDS), sample_type="dpm++ 2m")
    args = T2VArgs(**FIELDS)
    noise = _start(11, (1, 4, 8, 8, 4))
    res = pipe.infer(args, sample_type="dpm++ 2m", noise=noise)
    _check(res, want)
    done = []
    windowed = pipe.infer(args, sample_type="dpm++ 2m", noise=noise, callback=done.append,
                          callback_interval=2)
    assert done == [2, 4]
    np.testing.assert_array_equal(windowed.latents.numpy(), res.latents.numpy())
    # the JAX package's own refusals
    for kw, match in [(dict(sample_type="ddpm++"), "unknown sample_type"),
                      (dict(sample_type="dpm++ 2m", uc_type="cfg_ours"), "does not support"),
                      (dict(sample_type="dpm++ 2m", mask=torch.ones(1)), "does not support"),
                      (dict(sample_type="ddpm", callback=done.append), "takes no callback")]:
        with pytest.raises(ValueError, match=match):
            pipe.infer(args, **kw)


def test_ddpm_chain_matches_jax(pipelines):
    """``sample_type='ddpm'`` over a 30-timestep LVDM schedule: every
    timestep, full CFG, no x0 clip."""
    jpipe, pipe = pipelines
    jsched = JSchedule.from_betas(j_beta_schedule("linear", 30, 0.00085, 0.012))
    jp = dataclasses.replace(jpipe, schedule=jsched, _sample_cache={})
    tp = dataclasses.replace(pipe, schedule=DiffusionSchedule.from_betas(
        beta_schedule("linear", 30, 0.00085, 0.012)))
    want = jp.infer(JArgs(**FIELDS), sample_type="ddpm")
    shape = (1, 4, 8, 8, 4)
    res = tp.infer(T2VArgs(**FIELDS), sample_type="ddpm", noise=_start(11, shape),
                   ddpm_noise=_jax_draws("ddpm_noise", 11, 30, shape))
    _check(res, want)


def test_fps_model_with_adapter_features_matches_jax(pipelines):
    """An FPS-conditioned model (the JAX package's embedder parameters
    through ``from_jax``) with T2I-Adapter features of the same random state
    dict on both sides and ``cfg_original``; a missing ``cond_fps`` raises,
    and 8 and 24 frames a second differ."""
    jpipe, pipe = pipelines
    rng = np.random.default_rng(7)
    emb = jvc.FPSEmbedder(model_channels=FPS_CFG.model_channels)
    fps_params = _perturbed(jax.jit(emb.init)(jax.random.key(3), jnp.zeros((1,))), rng)
    jp = dataclasses.replace(jpipe, cfg=FPS_CFG, cond_stage2_params=fps_params,
                             _sample_cache={})
    tp = VideoCrafterPipeline.from_jax(jpipe.unet_params, jpipe.vae_params, jpipe.clip_params,
                                       FPS_CFG, Policy.fp32(), device="cpu",
                                       fps_params=fps_params)
    _close(tp.embed_fps(8).numpy(), np.asarray(jp.embed_fps(8)))

    acfg = AdapterConfig(channels=(32, 32, 64), nums_rb=1, ksize=1, sk=True, use_conv=False)
    adapter = Adapter(acfg).eval()
    init_weights(adapter, 4)
    sd = {k: v.numpy() for k, v in adapter.state_dict().items()}
    depth = rng.uniform(-1, 1, (1, 4, 32, 32, 1)).astype(np.float32)
    jfeats = tuple(f.reshape((1, 4) + f.shape[1:]) for f in JAdapter(cfg=acfg).apply(
        convert_adapter(sd, acfg), jnp.asarray(depth.reshape(4, 32, 32, 1))))
    feats = tp.adapter_features(adapter, depth)
    assert [tuple(f.shape) for f in feats] == [(1, 4, 4, 4, 32), (1, 4, 2, 2, 32),
                                              (1, 4, 1, 1, 64)]
    for f, jf in zip(feats, jfeats):
        _close(f.numpy(), np.asarray(jf))

    fields = dict(FIELDS, cond_fps=8)
    want = jp.infer(JArgs(**fields), features_adapter=jfeats, uc_type="cfg_original")
    args = T2VArgs(**fields)
    noise = _start(11, (1, 4, 8, 8, 4))
    res = tp.infer(args, features_adapter=feats, uc_type="cfg_original", noise=noise)
    _check(res, want)
    plain = tp.infer(args, uc_type="cfg_original", noise=noise)
    faster = tp.infer(args.replace(cond_fps=24), features_adapter=feats,
                      uc_type="cfg_original", noise=noise)
    for other in (plain, faster):
        assert not np.array_equal(other.latents.numpy(), res.latents.numpy())
    with pytest.raises(ValueError, match="FPS-conditioned: set cond_fps"):
        tp.infer(T2VArgs(**FIELDS))


def test_fps_embedder_checkpoint_loading(tmp_path):
    """``cond_stage2_model.*`` weights map as the JAX package's
    ``convert_fps_embedder`` maps them and load bit for bit through
    ``from_model_dir``; a checkpoint without them loads a seeded fresh
    embedder with a warning."""
    from _torch_model_dir import vc_source_pipeline, write_vc_dir

    src = vc_source_pipeline(fps=True)
    other = {f"cond_stage2_model.{k}": v
             for k, v in src.fps_embedder.state_dict().items()}
    mapped = fps_embedder_state(other, src.cfg)
    theirs = convert_fps_embedder({k: v.numpy() for k, v in other.items()}, src.cfg)["params"]
    for i in (0, 2):
        np.testing.assert_array_equal(mapped[f"fps_embed.{i}.weight"].numpy().T,
                                      theirs[f"fps_embed_{i}"]["kernel"])
        np.testing.assert_array_equal(mapped[f"fps_embed.{i}.bias"].numpy(),
                                      theirs[f"fps_embed_{i}"]["bias"])
    assert fps_embedder_state({}, src.cfg) is None
    assert fps_embedder_state(dict(list(other.items())[:2]), src.cfg) is None

    model_dir = write_vc_dir(src, tmp_path / "fps", fps=True)
    pipe = VideoCrafterPipeline.from_model_dir(str(model_dir), Policy.fp32(), device="cpu")
    assert pipe.cfg.cond_stage2_key == "temporal_context"
    for name, t in src.fps_embedder.state_dict().items():
        assert torch.equal(pipe.fps_embedder.state_dict()[name], t)
    args = T2VArgs(prompt="a dog", steps=1, frames=2, width=16, height=16, seed=2, cond_fps=8)
    np.testing.assert_array_equal(pipe.infer(args).frames, src.infer(args).frames)

    bare = tmp_path / "bare"
    bare.mkdir()
    sd = lightning_state_dict(src.unet, src.vae, src.clip)
    torch.save({"state_dict": sd}, bare / "model.ckpt")
    (bare / "model_config.yaml").write_text((model_dir / "model_config.yaml").read_text())
    (bare / "bpe_simple_vocab_16e6.txt.gz").write_bytes(
        (model_dir / "bpe_simple_vocab_16e6.txt.gz").read_bytes())
    with pytest.warns(UserWarning, match="no compatible cond_stage2_model weights"):
        fresh = VideoCrafterPipeline.from_model_dir(str(bare), Policy.fp32(), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        again = VideoCrafterPipeline.from_model_dir(str(bare), Policy.fp32(), device="cpu")
    w = fresh.fps_embedder.fps_embed[0].weight
    assert torch.equal(w, again.fps_embedder.fps_embed[0].weight)
    assert not torch.equal(w, src.fps_embedder.fps_embed[0].weight)


def test_label_proj_matches_jax():
    """An embedding-valued ``y`` of another width (24) goes through
    ``label_proj`` into the time embedding, as the JAX UNet's does; a width
    that the UNet has no projection for raises."""
    from t2v_torch.io import convert

    cfg = VideoCrafterUNetConfig().tiny()
    unet = tvc.VideoCrafterUNet(cfg, label_dim=24).eval()
    init_weights(unet, 0)
    rng = np.random.default_rng(8)
    params = _perturbed(convert_vc_unet({k: v.numpy() for k, v in unet.state_dict().items()},
                                        cfg), rng)
    proj = {"kernel": rng.normal(size=(24, 128)).astype(np.float32),
            "bias": rng.normal(size=(128,)).astype(np.float32)}
    params["params"]["label_proj"] = proj
    sd = convert.from_jax_vc_unet(params, cfg)
    sd["label_proj.weight"], sd["label_proj.bias"] = proj["kernel"].T, proj["bias"]
    convert.load_into(unet, sd)
    x = rng.normal(size=(2, 4, 8, 8, 4)).astype(np.float32)
    t = np.array([10.0, 500.0], np.float32)
    ctx = rng.normal(size=(2, 77, cfg.context_dim)).astype(np.float32)
    y = rng.normal(size=(2, 24)).astype(np.float32)
    want = jax.jit(jvc.VideoCrafterUNet(cfg=jvc.VideoCrafterUNetConfig().tiny()).apply)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
        y=jnp.asarray(y))
    with torch.no_grad():
        got = unet(*map(torch.from_numpy, (x, t, ctx)), y=torch.from_numpy(y))
        assert not torch.equal(got, unet(*map(torch.from_numpy, (x, t, ctx))))
        with pytest.raises(ValueError, match="y of width 7"):
            unet(*map(torch.from_numpy, (x, t, ctx)), y=torch.zeros(2, 7))
    _close(got.numpy(), np.asarray(want), 1e-4)


def test_masked_temporal_attention_matches_jax():
    """A causal frame mask on the rel-pos temporal attention, in the
    resident token layout and in the frame layout, against the JAX module's
    masked (XLA) path at 1e-5; the dispatch routes a masked call to the plain
    version on any device."""
    from t2v.io.convert_vc import _temporal_attn
    from test_torch_vc_unet import _prefixed, _randomised
    from t2v_torch.kernels import attention

    dim, heads, dh, t = 16, 2, 8, 4
    mod = tvc.TemporalCrossAttention(dim, heads, dh, temporal_length=t).eval()
    params = {"params": _temporal_attn(_prefixed(_randomised(mod, 6), "a"), "a")}
    causal = np.tril(np.ones((t, t), np.float32))
    rng = np.random.default_rng(9)
    for frame_split, shape in ((t, (2 * t, 6, dim)), (None, (3, t, dim))):
        x = rng.normal(size=shape).astype(np.float32)
        jmod = jvc.TemporalCrossAttention(query_dim=dim, heads=heads, dim_head=dh,
                                          temporal_length=t, frame_split=frame_split)
        want = np.asarray(jmod.apply(params, jnp.asarray(x), mask=jnp.asarray(causal)))
        with torch.no_grad():
            got = mod(torch.from_numpy(x), frame_split=frame_split,
                      mask=torch.from_numpy(causal)).numpy()
            free = mod(torch.from_numpy(x), frame_split=frame_split).numpy()
        _close(got, want)
        assert not np.allclose(got, free)

    class Kernel(Exception):
        pass

    def barred(*a, **k):
        raise Kernel

    q = torch.randn(8, 3, 16).bfloat16()
    k2 = torch.zeros(4, 4, 8).bfloat16()
    saved = attention.relpos_takes, attention.relpos_mha
    attention.relpos_takes, attention.relpos_mha = (lambda *a: True), barred
    try:
        with pytest.raises(Kernel):
            attention.relpos_attention(q, q, q, k2, k2, 2, 4)
        out = attention.relpos_attention(q, q, q, k2, k2, 2, 4, mask=torch.from_numpy(causal))
        assert out.shape == q.shape and out.dtype == torch.bfloat16
    finally:
        attention.relpos_takes, attention.relpos_mha = saved


def test_run_and_cli_answer_the_new_flags(tmp_path):
    """``run`` and the CLI reach every new branch: the samplers, the CFG
    variants, mask inpainting from an image file, FPS conditioning and the
    depth adapter (precomputed depth maps, a stub estimator through
    ``run``, and a ``midas_v21_small``-layout checkpoint through the CLI),
    on a tiny model whose VAE has the published 8x spatial scale."""
    import cv2

    from _torch_model_dir import VOCAB, small_vc_pipeline
    from t2v_torch.cli.generate import main
    from t2v_torch.core.config import T2VOutputArgs, VAEConfig
    from t2v_torch.io import train_state
    from t2v_torch.models.depth import MidasSmall
    from t2v_torch.models.vae import AutoencoderKL
    from t2v_torch.pipeline import run as run_mod

    pipe = small_vc_pipeline()
    pipe.cfg = dataclasses.replace(pipe.cfg, num_res_blocks=2, cond_stage2_key="temporal_context")
    pipe.unet = tvc.VideoCrafterUNet(pipe.cfg).eval()
    pipe.fps_embedder = tvc.FPSEmbedder(pipe.cfg.model_channels).eval()
    pipe.vae_cfg = dataclasses.replace(VAEConfig().tiny(), ch_mult=(1, 1, 1, 1))
    pipe.vae = AutoencoderKL(pipe.vae_cfg).eval()
    for i, m in enumerate((pipe.unet, pipe.fps_embedder, pipe.vae)):
        init_weights(m, 20 + i)
    model_dir = tmp_path / "vc"
    train_state.save_weights(
        str(model_dir), unet_params=dict(pipe.unet.named_parameters()), vae=pipe.vae,
        clip=pipe.clip, unet_cfg=pipe.cfg, vae_cfg=pipe.vae_cfg, clip_cfg=pipe.clip_cfg,
        model_family="videocrafter", tokenizer_vocab=str(VOCAB))

    acfg = AdapterConfig(channels=(32, 64, 64, 64), nums_rb=1, ksize=1, sk=True, use_conv=False)
    adapter = Adapter(acfg)
    init_weights(adapter, 5)
    adapter_ckpt = tmp_path / "adapter.pth"
    torch.save({"state_dict": {f"adapter.{k}": v for k, v in adapter.state_dict().items()}},
               adapter_ckpt)
    midas = MidasSmall()
    init_weights(midas, 6)
    depth_ckpt = tmp_path / "midas.pt"
    torch.save(midas.state_dict(), depth_ckpt)
    video = tmp_path / "depth.mp4"
    writer = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"mp4v"), 8, (64, 64))
    rng = np.random.default_rng(0)
    for _ in range(3):
        writer.write(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8))
    writer.release()
    image = tmp_path / "src.png"
    cv2.imwrite(str(image), rng.integers(0, 255, (64, 64, 3), dtype=np.uint8))

    args = T2VArgs(prompt="x", steps=2, frames=2, width=64, height=64, seed=1, cfg_scale=9.0,
                   cond_fps=8)
    out = T2VOutputArgs(skip_video_creation=True)
    kw = dict(pipe=pipe, outdir=str(tmp_path / "out"), save_frames=False)
    calls = []
    real_infer = VideoCrafterPipeline.infer

    def spy(self, a, **k):
        calls.append(k)
        return real_infer(self, a, **k)

    VideoCrafterPipeline.infer = spy
    try:
        for extra in (dict(vc_sample_type="dpm++ 2m"), dict(vc_uc_type="cfg_ours"),
                      dict(adapter_ckpt=str(adapter_ckpt), adapter_video=str(video)),
                      dict(adapter_ckpt=str(adapter_ckpt), adapter_video=str(video),
                           depth_estimator=lambda f: f.mean(-1))):
            res = run_mod.run(args, out, **kw, **extra)
            assert "Model: VideoCrafter" in res.infotexts[0]
        assert calls[0]["sample_type"] == "dpm++ 2m" and calls[1]["uc_type"] == "cfg_ours"
        assert calls[0]["callback"] is not None
        assert [f.shape[2:4] for f in calls[2]["features_adapter"]] == [(8, 8), (4, 4), (2, 2),
                                                                       (1, 1)]
        run_mod.run(args.replace(inpainting_frames=2, inpainting_image=str(image)), out, **kw)
        assert calls[-1]["mask"][0, :, 0, 0, 0].tolist() == [1.0, 0.0]
        assert calls[-1]["source_latents"].shape == (1, 2, 8, 8, 4)
        ddpm_pipe = dataclasses.replace(pipe, schedule=DiffusionSchedule.from_betas(
            beta_schedule("linear", 4, 0.00085, 0.012)))
        run_mod.run(args, out, **dict(kw, pipe=ddpm_pipe), vc_sample_type="ddpm")
        assert calls[-1]["sample_type"] == "ddpm" and calls[-1]["callback"] is None
        with pytest.raises(ValueError, match="requires adapter_video"):
            run_mod.run(args, out, **kw, adapter_ckpt=str(adapter_ckpt))
        with pytest.raises(FileNotFoundError, match="missing.pth"):
            run_mod.run(args, out, **kw, adapter_ckpt=str(tmp_path / "missing.pth"),
                        adapter_video=str(video))
        (tmp_path / "bad.pth").write_bytes(b"not a checkpoint")
        with pytest.raises(Exception, match="bad.pth"):
            run_mod.run(args, out, **kw, adapter_ckpt=str(tmp_path / "bad.pth"),
                        adapter_video=str(video))

        calls.clear()
        cli = ["--device", "cpu", "--model-type", "VideoCrafter", "--model-dir", str(model_dir),
               "--prompt", "x", "--steps", "2", "--frames", "2", "--width", "64", "--height",
               "64", "--seed", "1", "--cond-fps", "8", "--skip-video-creation", "--outdir",
               str(tmp_path / "cli")]
        for extra in (["--vc-sample-type", "dpm++ 2m"], ["--uc-type", "cfg_original"],
                      ["--adapter-ckpt", str(adapter_ckpt), "--adapter-video", str(video),
                       "--depth-ckpt", str(depth_ckpt)]):
            assert main(cli + extra) == 0
        assert calls[0]["sample_type"] == "dpm++ 2m" and calls[1]["uc_type"] == "cfg_original"
        assert len(calls[2]["features_adapter"]) == 4
        with pytest.raises(SystemExit, match="--adapter-ckpt: the depth adapter conditions"):
            main(["--device", "cpu", "--adapter-ckpt", str(adapter_ckpt)])
    finally:
        VideoCrafterPipeline.infer = real_infer
        run_mod._warm_pipe = None
