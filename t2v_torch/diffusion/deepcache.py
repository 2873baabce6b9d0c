"""DeepCache-style accelerated sampling (opt-in), in PyTorch.

The port of the JAX package's ``diffusion/deepcache.py``. Across adjacent
denoising steps the UNet's deep-trunk activations change slowly, so the
full network runs only every ``interval`` steps; in between, the cached
deep feature is combined with freshly computed shallow layers (the UNet's
``return_deep`` / ``deep_feature`` hooks). It is an approximation, off by
default (interval 1 is exact). It supports the single-state samplers
(DDIM_Gaussian, DDIM, Euler, Euler a).

The JAX package carries (x, deep feature) through ``lax.scan`` with a
``lax.cond`` between the full and the cached pass, starting from a zero
feature of the right shape (``deepcache_feat0``), and runs interruptible
requests in jitted windows (``run_deepcache_window``). Here one Python loop
carries (x, feature): step 0 is always a full pass, so the loop starts with
no feature at all, and the request's callback runs between steps.
"""

from __future__ import annotations

from typing import Callable

import torch

from t2v_torch.core.profiling import span
from t2v_torch.diffusion import ddim as ddim_mod
from t2v_torch.diffusion import ddim_gaussian as gaussian_mod
from t2v_torch.diffusion import euler as euler_mod
from t2v_torch.diffusion import sampling as sampling_mod
from t2v_torch.diffusion.schedules import DiffusionSchedule

SAMPLERS = {
    "DDIM_Gaussian": gaussian_mod,
    "DDIM": ddim_mod,
    "Euler": euler_mod,
    "Euler a": euler_mod.ancestral,
}


def deepcache_plan(sampler_name: str, schedule: DiffusionSchedule, steps: int, eta: float):
    """(mod, plan) of a DeepCache-capable sampler; plan.steps is the true
    step count (DDIM rounds up when T % steps != 0)."""
    if sampler_name not in SAMPLERS:
        raise ValueError(f"deepcache supports {list(SAMPLERS)}, not {sampler_name}")
    mod = SAMPLERS[sampler_name]
    return mod, mod.plan(schedule, steps, eta)


def make_deepcache_body(mod, p, apply_full, apply_cached, cond, uncond, guidance_scale, eta,
                        interval: int, parameterization: str = "eps", schedule=None,
                        noise: sampling_mod.LoopNoise | None = None):
    """body(x, feature, i) -> (x, feature). ``apply_full(x, t, ctx)`` returns
    (output, deep feature); ``apply_cached(x, t, ctx, feature)`` the output."""
    convert = sampling_mod.make_out_to_eps(parameterization, schedule)
    _, model_in, to_eps = sampling_mod.make_cfg_batcher(cond, uncond, guidance_scale,
                                                        mod.CFG_COMBINE)
    noise = noise or sampling_mod.LoopNoise()
    draws = sampling_mod.needs_step_noise(mod, eta)

    def body(x, feat, i: int):
        t = float(p.timesteps[i])
        x2, tt, cc = model_in(x, t, i)
        if i % interval == 0:
            out, feat = apply_full(x2, tt, cc)
        else:
            out = apply_cached(x2, tt, cc, feat)
        eps = convert(to_eps(out), x, t).to(torch.float32)
        x = mod.step(x, eps, p, i, noise.step(i, x) if draws else None)
        return x, feat

    return body


@torch.no_grad()
def sample_loop_deepcache(
    apply_full: Callable,
    apply_cached: Callable,
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
    step_noise=None,
    interval: int = 3,
    parameterization: str = "eps",
    callback: Callable[[int], None] | None = None,
    callback_interval: int | None = None,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """The final float32 x0 latent, like ``sampling.sample_loop`` (txt2vid).
    Random draws follow ``sample_loop``'s order: the starting latent, then
    each step's noise where the sampler needs it."""
    if device is None:
        device = cond.device
    mod, p = deepcache_plan(sampler_name, schedule, steps, eta)
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    x = noise.to(device=device, dtype=torch.float32)
    body = make_deepcache_body(mod, p, apply_full, apply_cached, cond, uncond, guidance_scale,
                               eta, interval, parameterization, schedule,
                               sampling_mod.LoopNoise(generator, step_noise))
    progress = sampling_mod._Progress(callback, callback_interval, p.steps)
    feat = None
    for i in range(p.steps):
        with span("t2v.step"):
            x, feat = body(x, feat, i)
            progress(i + 1)
    return x
