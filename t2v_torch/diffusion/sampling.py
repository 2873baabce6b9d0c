"""Sampler registry and the sampling loop of the port.

The PyTorch counterpart of the JAX package's ``diffusion/sampling.py``:

  * the registry holds the seven public sampler names (DDIM_Gaussian,
    DDIM, UniPC, DPM++ 2M, DPM++ 2M Karras, Euler, Euler a);
  * classifier-free guidance is fused: one model call on the
    ``[uncond; cond]`` doubled batch per step (``make_cfg_batcher``);
  * model outputs of v- and x0-parameterised models convert to eps
    (``make_out_to_eps``), and to the x0 prediction that the multistep
    samplers take (``_unipc_model_fn``);
  * vid2vid starts from re-noised source latents; img2vid inpainting starts
    from masked latents and, with ``inpaint_mode='progressive'``
    (DDIM_Gaussian) or ``'lvdm_static'``, blends the source back in after
    every step;
  * prompt-editing conditionings are per-step tables indexed by the step.

The JAX package compiles the loop as ``lax.scan`` and, to poll an interrupt,
runs it in jitted windows (and UniPC and DPM++ in their own windowed
segments). PyTorch runs eagerly, so every sampler is one Python loop; the
request's ``callback(done)`` runs after every ``callback_interval`` steps
(and after the last), where it may raise to stop the request. A windowed
request therefore computes exactly what an un-windowed one does.

Randomness: the JAX package draws each step's noise from named streams of
its key. The port draws from one ``torch.Generator`` in a fixed order: the
starting latent (``noise``), then at each step i the sampler's step noise
(when eta > 0 or the sampler always needs it, as Euler a does) and after it
the inpainting blend's re-noise (when a blend runs at that step). Tests hand
in the JAX package's draws instead, as ``noise``, ``step_noise[i]`` and
``inpaint_noise[i]``.

Latent layout is ``(B, F, H, W, C)``; the sampler state stays float32
whatever the model's compute dtype.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Sequence

import torch

from t2v_torch.core.profiling import span
from t2v_torch.diffusion import ddim as ddim_mod
from t2v_torch.diffusion import ddim_gaussian as gaussian_mod
from t2v_torch.diffusion import dpmpp as dpmpp_mod
from t2v_torch.diffusion import euler as euler_mod
from t2v_torch.diffusion import unipc as unipc_mod
from t2v_torch.diffusion.schedules import DiffusionSchedule

INPAINT_MODES = ("initial_only", "progressive", "lvdm_static")


@dataclass(frozen=True)
class SamplerSpec:
    name: str
    module: Any

    @property
    def frame_inpaint_support(self) -> bool:
        return bool(getattr(self.module, "FRAME_INPAINT_SUPPORT", False))


available_samplers: tuple[SamplerSpec, ...] = (
    SamplerSpec("DDIM_Gaussian", gaussian_mod),
    SamplerSpec("DDIM", ddim_mod),
    SamplerSpec("UniPC", unipc_mod),
    SamplerSpec("DPM++ 2M", dpmpp_mod),
    SamplerSpec("DPM++ 2M Karras", dpmpp_mod.karras),
    SamplerSpec("Euler", euler_mod),
    SamplerSpec("Euler a", euler_mod.ancestral),
)
SAMPLERS = {s.name: s.module for s in available_samplers}


def get_sampler(name: str):
    """The sampler module (or variant object) registered under ``name``."""
    if name not in SAMPLERS:
        raise ValueError(f"Sampler {name} does not exist.")
    return SAMPLERS[name]


def _cond_at(cond: torch.Tensor, step: int) -> torch.Tensor:
    """cond: (B, L, D) static or (S, B, L, D) per-step table."""
    if cond.dim() == 4:
        return cond[min(step, cond.shape[0] - 1)]
    return cond


def cfg_combine(y, u, scale: float, mode: str):
    """Classifier-free guidance combine over the channel (last) axis.
    "full": u + s*(y-u); "split_learned_range": guidance on the first C//2
    channels, the rest copied from the conditional branch (DDIM_Gaussian);
    "cfg_original" / "cfg_ours": the LVDM uc_type variants y + s*(y-u) and
    y + s*(u-y)."""
    if mode == "full":
        return u + scale * (y - u)
    if mode == "split_learned_range":
        d = y.shape[-1] // 2
        guided = u[..., :d] + scale * (y[..., :d] - u[..., :d])
        return torch.cat([guided, y[..., d:]], dim=-1)
    if mode == "cfg_original":
        return y + scale * (y - u)
    if mode == "cfg_ours":
        return y + scale * (u - y)
    raise ValueError(mode)


def make_cfg_batcher(cond, uncond, guidance_scale, combine: str):
    """(do_cfg, model_in, combine_out): the fused-CFG batching shared by
    ``make_eps_fn`` and the DeepCache body."""
    do_cfg = not (uncond is None or guidance_scale is None or guidance_scale == 1)

    def model_in(x, t: float, step: int):
        b = x.shape[0]
        c = _cond_at(cond, step)
        tt = torch.full((b,), float(t), dtype=torch.float32, device=x.device)
        if not do_cfg:
            return x, tt, c
        uc = _cond_at(uncond, step)
        return torch.cat([x, x]), torch.cat([tt, tt]), torch.cat([uc, c])

    def combine_out(out):
        if not do_cfg:
            return out
        u, y = out.chunk(2, dim=0)
        return cfg_combine(y, u, guidance_scale, combine)

    return do_cfg, model_in, combine_out


def make_out_to_eps(parameterization: str | None, schedule: DiffusionSchedule | None) -> Callable:
    """Model output -> eps for the model's prediction target, at the
    integer timestep t: v: eps = sqrt(abar_t) v + sqrt(1 - abar_t) x;
    x0: eps = (x - sqrt(abar_t) x0) / sqrt(1 - abar_t). Extra output
    channels (a learned variance) pass through. Returns convert(out, x, t)."""
    if parameterization in (None, "eps"):
        return lambda out, x, t: out
    if parameterization not in ("v", "x0"):
        raise ValueError(f"parameterization {parameterization!r}")
    if schedule is None:
        raise ValueError("non-eps parameterization needs the schedule")
    sa, s1ma = schedule.sqrt_alphas_cumprod, schedule.sqrt_one_minus_alphas_cumprod

    def convert(out, x, t):
        a, b = float(sa[int(t)]), float(s1ma[int(t)])
        out = out.to(x.dtype)
        c = x.shape[-1]
        mean, rest = out[..., :c], out[..., c:]
        eps = a * mean + b * x if parameterization == "v" else (x - a * mean) / b
        if rest.shape[-1]:
            eps = torch.cat([eps, rest], dim=-1)
        return eps

    return convert


def make_eps_fn(apply_fn: Callable, cond, uncond, guidance_scale: float, combine: str,
                parameterization: str = "eps",
                schedule: DiffusionSchedule | None = None) -> Callable:
    """eps_fn(x, t, step) with fused-CFG batching; ``apply_fn(x, t, ctx)``
    is the model. CFG combines the raw outputs and the combination is then
    converted, which equals converting each (both maps are affine)."""
    _, model_in, combine_out = make_cfg_batcher(cond, uncond, guidance_scale, combine)
    convert = make_out_to_eps(parameterization, schedule)

    def eps_fn(x, t, step):
        return convert(combine_out(apply_fn(*model_in(x, t, step))), x, t)

    return eps_fn


def _unipc_model_fn(apply_fn, cond, uncond, guidance_scale, p, parameterization: str = "eps"):
    """x0 ("data") prediction with full-channel CFG for the multistep
    samplers, through the plan's continuous-time (alpha_s, sigma_s):
    eps: x0 = (x - sigma_s eps) / alpha_s; v: x0 = alpha_s x - sigma_s v;
    x0: the output itself."""
    out_fn = make_eps_fn(apply_fn, cond, uncond, guidance_scale, "full")

    def model_fn(x, t_input, s):
        out = out_fn(x, t_input, s).to(x.dtype)
        a, sg = float(p.alpha[s]), float(p.sigma[s])
        if parameterization == "x0":
            return out
        if parameterization == "v":
            return a * x - sg * out
        return (x - sg * out) / a

    return model_fn


@dataclass
class LoopNoise:
    """Where the loop's random draws come from: the given tables (indexed by
    the plan step), else ``generator`` on ``device`` in call order."""

    generator: torch.Generator | None = None
    step_noise: Sequence[torch.Tensor] | None = None
    inpaint_noise: Sequence[torch.Tensor] | None = None

    def _draw(self, table, i: int, like: torch.Tensor) -> torch.Tensor:
        if table is not None:
            return torch.as_tensor(table[i]).to(device=like.device, dtype=torch.float32)
        return torch.randn(like.shape, generator=self.generator, device=like.device,
                           dtype=torch.float32)

    def step(self, i: int, like: torch.Tensor) -> torch.Tensor:
        return self._draw(self.step_noise, i, like)

    def inpaint(self, i: int, like: torch.Tensor) -> torch.Tensor:
        return self._draw(self.inpaint_noise, i, like)


def needs_step_noise(mod, eta: float) -> bool:
    return (eta > 0 and getattr(mod, "USES_ETA", True)) or getattr(mod, "NEEDS_STEP_NOISE", False)


def _inpaint_blend(x, step: int, steps: int, mask, image_latents, schedule, t_cur: int, noise):
    """Progressive inpainting: the keyframe weights harden into a binary
    mask over the steps (keep where mask > (steps - step - 1) / steps) and
    the rest is re-noised from the source latents at the step's timestep.
    The caller skips the last step, where re-noised regions would survive
    into the output."""
    v = (steps - step - 1.0) / steps
    binary = (mask > v).to(x.dtype)
    renoised = (float(schedule.sqrt_alphas_cumprod[t_cur]) * image_latents
                + float(schedule.sqrt_one_minus_alphas_cumprod[t_cur]) * noise)
    return renoised * (1.0 - binary) + x * binary


def _lvdm_mask_blend(x, mask, image_latents, schedule, t_next: int, noise):
    """LVDM's static mask blend: after each update the known regions (mask
    1 keeps the source) are re-imposed as q_sample(source, t_next)."""
    known = (float(schedule.sqrt_alphas_cumprod[t_next]) * image_latents
             + float(schedule.sqrt_one_minus_alphas_cumprod[t_next]) * noise)
    m = mask.to(x.dtype)
    return known * m + (1.0 - m) * x


def make_step_body(mod, p, apply_fn, cond, uncond, guidance_scale, eta, mask, image_latents,
                   inpaint_mode, schedule, cfg_combine_mode=None, parameterization: str = "eps",
                   noise: LoopNoise | None = None):
    """body(x, i) -> x: step i of a single-state sampler (DDIM_Gaussian,
    DDIM, Euler, Euler a), with its step noise and mask blend."""
    eps_fn = make_eps_fn(apply_fn, cond, uncond, guidance_scale,
                         cfg_combine_mode or mod.CFG_COMBINE, parameterization, schedule)
    noise = noise or LoopNoise()
    steps = p.steps
    draws = needs_step_noise(mod, eta)
    blend = mask is not None and image_latents is not None
    progressive = blend and inpaint_mode == "progressive" and mod.FRAME_INPAINT_SUPPORT
    lvdm_static = blend and inpaint_mode == "lvdm_static"

    def body(x, i: int):
        eps = eps_fn(x, float(p.timesteps[i]), i).to(x.dtype)
        x = mod.step(x, eps, p, i, noise.step(i, x) if draws else None)
        t = int(p.timesteps[i])
        if progressive and i < steps - 1:
            x = _inpaint_blend(x, i, steps, mask, image_latents, schedule, t, noise.inpaint(i, x))
        elif lvdm_static:
            # blended at t - 1 where t is the CURRENT timestep, as LVDM does
            x = _lvdm_mask_blend(x, mask, image_latents, schedule, max(t - 1, 0),
                                 noise.inpaint(i, x))
        return x

    return body


class _Progress:
    """Calls ``callback(done)`` after every ``interval`` steps and after the
    last (only after the last without an interval)."""

    def __init__(self, callback, interval: int | None, total: int):
        self.callback, self.interval, self.total = callback, interval, total

    def __call__(self, done: int) -> None:
        if self.callback is None:
            return
        if done == self.total or (self.interval and done % self.interval == 0):
            self.callback(done)


def _start_state(mod, schedule, noise, latents, is_vid2vid, strength, steps):
    if latents is not None and is_vid2vid:
        return mod.encode_vid2vid(schedule, latents, noise, strength, steps)
    return latents if latents is not None else noise


def plan_and_start(schedule: DiffusionSchedule, *, steps: int, shape: tuple[int, ...],
                   eta: float = 0.0, sampler_name: str = "DDIM_Gaussian",
                   generator: torch.Generator | None = None, noise: torch.Tensor | None = None,
                   latents=None, is_vid2vid: bool = False, strength: float = 1.0,
                   device: torch.device | str | None = None):
    """The pre-loop part of ``sample_loop`` for the single-state samplers:
    the sampler module, its plan (truncated for DDIM vid2vid) and the
    float32 starting state. ``noise`` is drawn from ``generator`` when not
    given."""
    mod = get_sampler(sampler_name)
    if getattr(mod, "MULTISTEP", False):
        raise ValueError(f"plan_and_start takes a single-state sampler, not {mod.NAME}")
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    noise = noise.to(device=device, dtype=torch.float32)
    if latents is not None:
        latents = latents.to(device=device, dtype=torch.float32)
    if latents is not None and is_vid2vid and mod is ddim_mod:
        p_full = ddim_mod.plan(schedule, steps, eta)
        t_enc = int(strength * steps)
        x = ddim_mod.stochastic_encode(p_full, latents, noise, t_enc)
        return mod, ddim_mod.truncate_for_vid2vid(p_full, t_enc), x.float()
    x = _start_state(mod, schedule, noise, latents, is_vid2vid, strength, steps)
    return mod, mod.plan(schedule, steps, eta), x.float()


@torch.no_grad()
def sample_loop(
    apply_fn: Callable,
    schedule: DiffusionSchedule,
    *,
    steps: int,
    shape: tuple[int, ...],
    cond,
    uncond=None,
    guidance_scale: float = 1.0,
    eta: float = 0.0,
    sampler_name: str = "DDIM_Gaussian",
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
    latents: torch.Tensor | None = None,
    is_vid2vid: bool = False,
    strength: float = 1.0,
    mask: torch.Tensor | None = None,
    image_latents: torch.Tensor | None = None,
    inpaint_mode: str = "initial_only",
    cfg_combine_mode: str | None = None,
    parameterization: str = "eps",
    callback: Callable[[int], None] | None = None,
    callback_interval: int | None = None,
    step_noise: Sequence[torch.Tensor] | None = None,
    inpaint_noise: Sequence[torch.Tensor] | None = None,
    device: torch.device | str | None = None,
    draws: LoopNoise | None = None,
) -> torch.Tensor:
    """Denoise for ``steps`` steps with any registered sampler; returns the
    final float32 latent of ``shape`` (B, F, H, W, C).

    apply_fn(x, t, context) -> model output, x: (B, F, H, W, C), t: (B,).
    ``draws`` replaces the source of the in-loop draws (by default
    ``generator`` and the ``step_noise`` / ``inpaint_noise`` tables), as the
    sharded sampler's per-sample streams do (``parallel/dp_sample.py``).
    """
    if inpaint_mode not in INPAINT_MODES:
        raise ValueError(f"inpaint_mode {inpaint_mode!r} (one of {INPAINT_MODES})")
    mod = get_sampler(sampler_name)
    if device is None:
        device = cond.device
    draws = draws or LoopNoise(generator, step_noise, inpaint_noise)
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    noise = noise.to(device=device, dtype=torch.float32)

    if getattr(mod, "MULTISTEP", False):
        # multistep samplers guide all channels and take no in-loop mask
        # blend; a masked start still rides in through ``latents``
        if cfg_combine_mode not in (None, "full"):
            raise ValueError(f"sampler {sampler_name!r} supports only full-channel CFG "
                             f"(cfg_combine_mode={cfg_combine_mode!r})")
        if mask is not None and inpaint_mode in ("progressive", "lvdm_static"):
            raise ValueError(f"sampler {sampler_name!r} does not support {inpaint_mode!r} mask "
                             "blending — use DDIM_Gaussian (progressive) or DDIM (lvdm_static)")
        if latents is not None:
            latents = latents.to(device=device, dtype=torch.float32)
        x = _start_state(mod, schedule, noise, latents, is_vid2vid, strength, steps).float()
        t_start = strength if (is_vid2vid and strength is not None) else None
        p = mod.plan(schedule, steps, t_start=t_start)
        model_fn = _unipc_model_fn(apply_fn, cond, uncond, guidance_scale, p, parameterization)
        return mod.sample(x, model_fn, p, _Progress(callback, callback_interval, p.steps))

    mod, p, x = plan_and_start(
        schedule, steps=steps, shape=shape, eta=eta, sampler_name=sampler_name, noise=noise,
        latents=latents, is_vid2vid=is_vid2vid, strength=strength, device=device,
    )
    body = make_step_body(mod, p, apply_fn, cond, uncond, guidance_scale, eta, mask,
                          image_latents, inpaint_mode, schedule, cfg_combine_mode,
                          parameterization, draws)
    progress = _Progress(callback, callback_interval, p.steps)
    for i in range(p.steps):
        with span("t2v.step"):
            x = body(x, i)
            progress(i + 1)
    return x
