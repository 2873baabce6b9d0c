"""DDIM — the Stable-Diffusion-style DDIM sampler (the VideoCrafter
default), in PyTorch.

The port of the JAX package's ``diffusion/ddim.py``: the uniform timestep
subset with its sigma tables, full-channel CFG, the eps-parameterised
update x_t -> x_{t-1}, and the vid2vid entry (``stochastic_encode`` at
ascending index ``int(strength * steps)``, then the plan truncated to that
many rungs by ``truncate_for_vid2vid``). Plan tables are float32 numpy in
sampling order (descending t); ``step`` reads the per-step scalars as
Python floats.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from t2v_torch.diffusion.schedules import (
    DiffusionSchedule,
    make_ddim_sampling_parameters,
    make_ddim_timesteps,
)

NAME = "DDIM"
FRAME_INPAINT_SUPPORT = False
CFG_COMBINE = "full"


@dataclass(frozen=True)
class Plan:
    """Per-step tables in sampling order (descending t), shape (steps,)."""

    timesteps: np.ndarray  # int32, descending: model input t per step
    alphas: np.ndarray
    alphas_prev: np.ndarray
    sqrt_one_minus_alphas: np.ndarray
    sigmas: np.ndarray
    steps: int
    # ascending tables kept for stochastic_encode
    ddim_alphas_asc: np.ndarray


def plan(schedule: DiffusionSchedule, steps: int, eta: float = 0.0) -> Plan:
    ts_asc = make_ddim_timesteps(steps, schedule.num_timesteps)
    # the uniform subset has ceil(T/stride) entries and the sampler runs all
    # of them, which can exceed the requested count when steps does not
    # divide T; the +1 offset can also reach T, hence the clamp
    ts_asc = np.minimum(ts_asc, schedule.num_timesteps - 1)
    steps = len(ts_asc)
    sigmas, alphas, alphas_prev = make_ddim_sampling_parameters(
        schedule.alphas_cumprod, ts_asc, eta
    )
    flip = lambda a: np.ascontiguousarray(a[::-1])
    return Plan(
        timesteps=flip(ts_asc).astype(np.int32),
        alphas=flip(alphas),
        alphas_prev=flip(alphas_prev),
        sqrt_one_minus_alphas=flip(np.sqrt(1.0 - alphas)),
        sigmas=flip(sigmas),
        steps=steps,
        ddim_alphas_asc=alphas,
    )


def truncate_for_vid2vid(p: Plan, t_start: int) -> Plan:
    """vid2vid decodes over the first ``t_start`` ascending rungs only, i.e.
    the last ``t_start`` entries of the tables in sampling order."""
    sl = slice(p.steps - t_start, None)
    return Plan(
        timesteps=p.timesteps[sl],
        alphas=p.alphas[sl],
        alphas_prev=p.alphas_prev[sl],
        sqrt_one_minus_alphas=p.sqrt_one_minus_alphas[sl],
        sigmas=p.sigmas[sl],
        steps=t_start,
        ddim_alphas_asc=p.ddim_alphas_asc,
    )


def step(x: torch.Tensor, eps: torch.Tensor, p: Plan, i: int, noise) -> torch.Tensor:
    """One DDIM update (temperature 1); ``noise`` (standard normal, x's
    shape) is read only when the step's sigma is non-zero."""
    a_t = np.float32(p.alphas[i])
    a_prev = np.float32(p.alphas_prev[i])
    sigma = np.float32(p.sigmas[i])
    eps = eps.to(x.dtype)
    pred_x0 = (x - float(p.sqrt_one_minus_alphas[i]) * eps) / float(np.sqrt(a_t))
    dir_xt = float(np.sqrt(np.float32(1.0) - a_prev - sigma * sigma)) * eps
    out = float(np.sqrt(a_prev)) * pred_x0 + dir_xt
    if sigma != 0:
        out = out + float(sigma) * noise
    return out


def stochastic_encode(p: Plan, latent, noise, t_enc: int):
    """q-sample at ascending DDIM index ``t_enc`` (clamped to the table)."""
    t_enc = min(int(t_enc), len(p.ddim_alphas_asc) - 1)
    sa = float(np.sqrt(p.ddim_alphas_asc[t_enc]))
    sb = float(np.sqrt(1.0 - p.ddim_alphas_asc[t_enc]))
    return sa * latent + sb * noise
