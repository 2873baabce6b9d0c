"""Sampling loop of the port: the single-state samplers (DDIM_Gaussian,
DDIM) of the JAX package's ``diffusion/sampling.py`` as a Python step loop.

Classifier-free guidance is fused: one model call on the ``[uncond; cond]``
doubled batch per step. Prompt-editing conditionings are per-step tables
indexed by the step (``_cond_at``). Latent layout is ``(B, F, H, W, C)``;
the sampler state stays float32 whatever the model's compute dtype.
"""

from __future__ import annotations

from typing import Callable

import torch

from t2v_torch.diffusion import ddim as ddim_mod
from t2v_torch.diffusion import ddim_gaussian as gaussian_mod
from t2v_torch.diffusion.schedules import DiffusionSchedule

SAMPLERS = {"DDIM_Gaussian": gaussian_mod, "DDIM": ddim_mod}


def get_sampler(name: str):
    if name not in SAMPLERS:
        raise ValueError(f"Sampler {name} is not ported yet (ported: {sorted(SAMPLERS)})")
    return SAMPLERS[name]


def _cond_at(cond: torch.Tensor, step: int) -> torch.Tensor:
    """cond: (B, L, D) static or (S, B, L, D) per-step table."""
    if cond.dim() == 4:
        return cond[min(step, cond.shape[0] - 1)]
    return cond


def cfg_combine(y, u, scale: float, mode: str):
    """Classifier-free guidance combine over the channel (last) axis.
    "full": u + s*(y-u); "split_learned_range": guidance on the first C//2
    channels, the rest copied from the conditional branch (DDIM_Gaussian)."""
    if mode == "full":
        return u + scale * (y - u)
    if mode == "split_learned_range":
        d = y.shape[-1] // 2
        guided = u[..., :d] + scale * (y[..., :d] - u[..., :d])
        return torch.cat([guided, y[..., d:]], dim=-1)
    raise ValueError(mode)


def make_cfg_batcher(cond, uncond, guidance_scale, combine: str):
    """(do_cfg, model_in, combine_out): the fused-CFG batching."""
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
    device: torch.device | str | None = None,
    parameterization: str = "eps",
) -> torch.Tensor:
    """Denoise from ``noise`` (drawn from ``generator`` when not given) for
    ``steps`` steps; returns the final float32 latent of ``shape``.

    apply_fn(x, t, context) -> model output, x: (B, F, H, W, C), t: (B,).
    """
    mod = get_sampler(sampler_name)
    if parameterization != "eps":
        raise ValueError(f"parameterization {parameterization!r} is not ported yet")
    if device is None:
        device = cond.device
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    x = noise.to(device=device, dtype=torch.float32)
    p = mod.plan(schedule, steps, eta)
    _, model_in, combine_out = make_cfg_batcher(cond, uncond, guidance_scale, mod.CFG_COMBINE)
    for i in range(p.steps):
        eps = combine_out(apply_fn(*model_in(x, float(p.timesteps[i]), i)))
        step_noise = None
        if p.sigmas[i] != 0:
            step_noise = torch.randn(x.shape, generator=generator, device=device,
                                     dtype=torch.float32)
        x = mod.step(x, eps, p, i, step_noise)
    return x
