"""The port's seven samplers against the JAX package's, in float32 on the
CPU, on a toy model (no UNet: ``0.5 tanh(x)`` plus terms in t and in the
context, so CFG and the timestep both matter):

* the registry, every plan table and every vid2vid entry;
* the whole step loop of each sampler, txt2vid and vid2vid, with eta noise,
  both in-loop mask blends, v and x0 model targets, the LVDM CFG variant and
  a per-step conditioning table, fed the very noise the JAX loop draws
  from its key (its ``latent_noise``, ``ddim_eta`` and ``inpaint_noise``
  streams, folded with the step);
* a windowed loop equal to the monolithic one bit for bit, an interrupt
  that stops it, and the JAX package's refusals.

Tolerances: plan tables exactly where both sides run the same numpy code;
final latents to 2e-5 absolute and relative (float32 elementwise math in
another order over up to 10 steps of O(1) values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v.core import rng as jrng
from t2v.diffusion import ddim as jddim
from t2v.diffusion import ddim_gaussian as jgauss
from t2v.diffusion import dpmpp as jdpmpp
from t2v.diffusion import euler as jeuler
from t2v.diffusion import sampling as jsampling
from t2v.diffusion import unipc as junipc
from t2v.diffusion.schedules import DiffusionSchedule as JSchedule
from t2v_torch.core.state import InterruptedException
from t2v_torch.diffusion import ddim, ddim_gaussian, dpmpp, euler, sampling, unipc
from t2v_torch.diffusion.schedules import DiffusionSchedule
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

NAMES = ["DDIM_Gaussian", "DDIM", "UniPC", "DPM++ 2M", "DPM++ 2M Karras", "Euler", "Euler a"]
SHAPE = (1, 3, 4, 4, 4)
STEPS = 10
TOL = dict(rtol=2e-5, atol=2e-5)
SCHED, JSCHED = DiffusionSchedule.linear_sd(), JSchedule.linear_sd()


# (port module, JAX module) per sampler name
PAIRS = {"DDIM_Gaussian": (ddim_gaussian, jgauss), "DDIM": (ddim, jddim),
         "UniPC": (unipc, junipc), "DPM++ 2M": (dpmpp, jdpmpp),
         "DPM++ 2M Karras": (dpmpp.karras, jdpmpp.karras), "Euler": (euler, jeuler),
         "Euler a": (euler.ancestral, jeuler.ancestral)}


def test_registry_matches_jax():
    assert [s.name for s in sampling.available_samplers] == [s.name for s in
                                                             jsampling.available_samplers] == NAMES
    for mine, theirs in zip(sampling.available_samplers, jsampling.available_samplers):
        assert mine.frame_inpaint_support == theirs.frame_inpaint_support
        assert sampling.get_sampler(mine.name) is mine.module is PAIRS[mine.name][0]
        for flag in ("CFG_COMBINE", "MULTISTEP", "USES_ETA", "NEEDS_STEP_NOISE"):
            assert getattr(mine.module, flag, None) == getattr(theirs.module, flag, None), flag
    with pytest.raises(ValueError) as mine_err:
        sampling.get_sampler("DDPM")
    with pytest.raises(ValueError) as theirs_err:
        jsampling.get_sampler("DDPM")
    assert str(mine_err.value) == str(theirs_err.value)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("steps,arg", [(20, None), (7, 0.6)], ids=["20", "7-vid2vid-or-eta"])
def test_plans_match_jax(name, steps, arg):
    mine, theirs = PAIRS[name]
    multistep = getattr(mine, "MULTISTEP", False)
    # multistep plans take the vid2vid start time, the others eta
    extra = arg if multistep else (arg or 0.0)
    p = mine.plan(SCHED, steps, extra)
    q = theirs.plan(JSCHED, steps, extra)
    assert p.steps == q.steps
    fields = [f for f in vars(q) if f != "steps"]
    assert sorted(fields) == sorted(f for f in vars(p) if f != "steps")
    for f in fields:
        np.testing.assert_allclose(getattr(p, f), getattr(q, f), rtol=1e-12, atol=0, err_msg=f)


def test_ddim_vid2vid_truncation_matches_jax():
    p, q = ddim.plan(SCHED, 20, 0.3), jddim.plan(JSCHED, 20, 0.3)
    for t_enc in (5, 13):
        a, b = ddim.truncate_for_vid2vid(p, t_enc), jddim.truncate_for_vid2vid(q, t_enc)
        assert a.steps == b.steps == t_enc
        for f in ("timesteps", "alphas", "alphas_prev", "sqrt_one_minus_alphas", "sigmas"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("name", NAMES)
def test_vid2vid_encodes_match_jax(name):
    rng = np.random.default_rng(1)
    latent, noise = (rng.normal(size=SHAPE).astype(np.float32) for _ in range(2))
    mine, theirs = PAIRS[name]
    for strength in (0.3, 0.75):
        if name == "DDIM":
            t_enc = int(strength * 20)
            got = ddim.stochastic_encode(ddim.plan(SCHED, 20), torch.from_numpy(latent),
                                         torch.from_numpy(noise), t_enc)
            want = jddim.stochastic_encode(jddim.plan(JSCHED, 20), jnp.asarray(latent),
                                           jnp.asarray(noise), t_enc)
        else:
            got = mine.encode_vid2vid(SCHED, torch.from_numpy(latent), torch.from_numpy(noise),
                                      strength, 20)
            want = theirs.encode_vid2vid(JSCHED, jnp.asarray(latent), jnp.asarray(noise),
                                         strength, 20)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _toy_jax(x, t, ctx):
    """The toy model: (x (B, F, H, W, C), t (B,), ctx (B, L, D)) -> x's shape."""
    return 0.5 * jnp.tanh(x) + (1e-3 * t + 0.3 * ctx.mean(axis=(1, 2)))[:, None, None, None, None]


def _toy_torch(x, t, ctx):
    return 0.5 * torch.tanh(x) + (1e-3 * t + 0.3 * ctx.mean(dim=(1, 2)))[:, None, None, None, None]


def _jax_draws(key, n):
    """The JAX loop's draws from its key: the starting latent, and each
    step's eta and inpaint noise."""
    start = np.array(jrng.latent_noise(key, SHAPE))
    eta_key, inp_key = jrng.stream(key, "ddim_eta"), jrng.stream(key, "inpaint_noise")
    step = lambda k: [np.array(jax.random.normal(jax.random.fold_in(k, i), SHAPE, jnp.float32))
                      for i in range(n)]
    return start, step(eta_key), step(inp_key)


# (sampler, options): txt2vid for all seven; eta noise; vid2vid for all
# seven; both blends; initial-only inpainting start for a multistep sampler;
# v and x0 targets; LVDM CFG; a per-step conditioning table
CASES = (
    [(n, {}) for n in NAMES]
    + [("DDIM_Gaussian", {"eta": 0.6}), ("DDIM", {"eta": 0.6})]
    + [(n, {"vid2vid": 0.6}) for n in NAMES]
    + [("DDIM_Gaussian", {"blend": "progressive"}), ("DDIM", {"blend": "lvdm_static"}),
       ("UniPC", {"masked_start": True})]
    + [(n, {"parameterization": p}) for n in ("DDIM", "UniPC") for p in ("v", "x0")]
    + [("DDIM", {"cfg_combine_mode": "cfg_original"}), ("DDIM_Gaussian", {"scheduled": True})]
)


def _case_id(case):
    name, opts = case
    return "-".join([name.replace(" ", "_"), *(f"{k}={v}" for k, v in opts.items())])


def _loop_args(opts, rng):
    steps_cond = 4 if opts.get("scheduled") else None
    lead = (steps_cond,) if steps_cond else ()
    cond = rng.normal(size=(*lead, 1, 5, 8)).astype(np.float32)
    uncond = rng.normal(size=(*lead, 1, 5, 8)).astype(np.float32)
    source = rng.normal(size=SHAPE).astype(np.float32)
    mask = np.broadcast_to(rng.uniform(size=(1, SHAPE[1], 1, 1, 1)), SHAPE).astype(np.float32)
    return cond, uncond, source, mask


@pytest.mark.parametrize("name,opts", CASES, ids=[_case_id(c) for c in CASES])
def test_step_loop_matches_jax_under_its_own_noise(name, opts):
    rng = np.random.default_rng(7)
    cond, uncond, source, mask = _loop_args(opts, rng)
    key = jrng.key_for_seed(3)
    start, eta_noise, inpaint_noise = _jax_draws(key, 40)
    kw = dict(steps=STEPS, shape=SHAPE, guidance_scale=3.0, eta=opts.get("eta", 0.0),
              sampler_name=name, cfg_combine_mode=opts.get("cfg_combine_mode"),
              parameterization=opts.get("parameterization", "eps"))
    jkw, tkw = {}, {}
    if "vid2vid" in opts:
        jkw = dict(latents=jnp.asarray(source), is_vid2vid=True, strength=opts["vid2vid"])
        tkw = dict(latents=torch.from_numpy(source), is_vid2vid=True, strength=opts["vid2vid"])
    if "blend" in opts:
        jkw = dict(latents=jnp.asarray(start), mask=jnp.asarray(mask),
                   image_latents=jnp.asarray(source), inpaint_mode=opts["blend"])
        tkw = dict(latents=torch.from_numpy(start), mask=torch.from_numpy(mask),
                   image_latents=torch.from_numpy(source), inpaint_mode=opts["blend"])
    if opts.get("masked_start"):
        masked = source * (1 - mask) + start * mask
        jkw, tkw = dict(latents=jnp.asarray(masked)), dict(latents=torch.from_numpy(masked))
    want = jsampling.sample_loop(_toy_jax, JSCHED, cond=jnp.asarray(cond),
                                 uncond=jnp.asarray(uncond), key=key, **kw, **jkw)
    got = sampling.sample_loop(
        _toy_torch, SCHED, cond=torch.from_numpy(cond), uncond=torch.from_numpy(uncond),
        noise=torch.from_numpy(start), step_noise=[torch.from_numpy(n) for n in eta_noise],
        inpaint_noise=[torch.from_numpy(n) for n in inpaint_noise], **kw, **tkw)
    assert got.dtype == torch.float32 and got.shape == SHAPE
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_windowed_loop_equals_the_monolithic_one(name):
    rng = np.random.default_rng(2)
    cond, uncond = (torch.from_numpy(rng.normal(size=(1, 5, 8)).astype(np.float32))
                    for _ in range(2))
    kw = dict(steps=STEPS, shape=SHAPE, cond=cond, uncond=uncond, guidance_scale=3.0,
              sampler_name=name, eta=0.4)
    whole = sampling.sample_loop(_toy_torch, SCHED, generator=torch.Generator().manual_seed(4),
                                 **kw)
    seen = []
    windowed = sampling.sample_loop(_toy_torch, SCHED, generator=torch.Generator().manual_seed(4),
                                    callback=seen.append, callback_interval=3, **kw)
    assert torch.equal(whole, windowed)
    assert seen == [3, 6, 9, 10]
    ends = []
    sampling.sample_loop(_toy_torch, SCHED, generator=torch.Generator().manual_seed(4),
                         callback=ends.append, **kw)
    assert ends == [10]


@pytest.mark.parametrize("name", ["DDIM_Gaussian", "UniPC"])
def test_an_interrupt_from_the_callback_stops_the_loop(name):
    calls = []

    def model(x, t, ctx):
        calls.append(float(t[0]))
        return _toy_torch(x, t, ctx)

    def stop(done):
        if done == 4:
            raise InterruptedException

    cond = torch.zeros(1, 5, 8)
    with pytest.raises(InterruptedException):
        sampling.sample_loop(model, SCHED, steps=STEPS, shape=SHAPE, cond=cond, uncond=cond,
                             guidance_scale=3.0, sampler_name=name, callback=stop,
                             callback_interval=2, generator=torch.Generator().manual_seed(0))
    # four steps ran (UniPC's first model call is the starting rung's)
    assert len(calls) == 4 + (name == "UniPC")


def test_refusals_match_jax():
    cond = torch.zeros(1, 5, 8)
    kw = dict(steps=4, shape=SHAPE, cond=cond, generator=torch.Generator())
    with pytest.raises(ValueError, match="full-channel CFG"):
        sampling.sample_loop(_toy_torch, SCHED, sampler_name="UniPC",
                             cfg_combine_mode="split_learned_range", **kw)
    with pytest.raises(ValueError, match="mask blending"):
        sampling.sample_loop(_toy_torch, SCHED, sampler_name="DPM++ 2M", mask=torch.ones(SHAPE),
                             image_latents=torch.ones(SHAPE), inpaint_mode="progressive", **kw)
    with pytest.raises(ValueError, match="single-state sampler, not UniPC"):
        sampling.plan_and_start(SCHED, steps=4, shape=SHAPE, sampler_name="UniPC")
    with pytest.raises(ValueError, match="windowed execution does not support UniPC"):
        jsampling.plan_and_start(JSCHED, steps=4, shape=SHAPE, sampler_name="UniPC")


@pytest.mark.parametrize("parameterization", ["v", "x0"])
def test_out_to_eps_matches_jax(parameterization):
    rng = np.random.default_rng(3)
    out = rng.normal(size=(1, 2, 3, 3, 8)).astype(np.float32)   # learned-variance channels
    x = rng.normal(size=(1, 2, 3, 3, 4)).astype(np.float32)
    got = sampling.make_out_to_eps(parameterization, SCHED)(torch.from_numpy(out),
                                                            torch.from_numpy(x), 481.0)
    want = jsampling.make_out_to_eps(parameterization, JSCHED)(jnp.asarray(out), jnp.asarray(x),
                                                                481.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_mask_blends_match_jax():
    rng = np.random.default_rng(5)
    x, img, noise = (rng.normal(size=SHAPE).astype(np.float32) for _ in range(3))
    mask = np.broadcast_to(rng.uniform(size=(1, 3, 1, 1, 1)), SHAPE).astype(np.float32)
    tables = (jnp.asarray(JSCHED.sqrt_alphas_cumprod),
              jnp.asarray(JSCHED.sqrt_one_minus_alphas_cumprod))
    key = jax.random.key(0)
    jnoise = np.asarray(jax.random.normal(key, SHAPE, jnp.float32))
    t = lambda a: torch.from_numpy(np.array(a))
    for step in (0, 4):
        want = jsampling._inpaint_blend(jnp.asarray(x), step, 10, jnp.asarray(mask),
                                        jnp.asarray(img), tables, 700, key)
        got = sampling._inpaint_blend(t(x), step, 10, t(mask), t(img), SCHED, 700, t(jnoise))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    want = jsampling._lvdm_mask_blend(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(img), tables,
                                      321, key)
    got = sampling._lvdm_mask_blend(t(x), t(mask), t(img), SCHED, 321, t(jnoise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_unipc_orders_follow_the_warmup_and_lower_order_final():
    assert [unipc.order_at(s, 10) for s in range(1, 11)] == [1, 2, 3, 3, 3, 3, 3, 3, 2, 1]
    assert [unipc.order_at(s, 2) for s in range(1, 3)] == [1, 2]
