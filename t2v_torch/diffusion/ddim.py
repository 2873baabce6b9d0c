"""DDIM — the Stable-Diffusion-style DDIM sampler (the VideoCrafter
default), in PyTorch.

The port of the JAX package's ``diffusion/ddim.py`` on its txt2vid path:
the uniform timestep subset with its sigma tables, full-channel CFG, and
the eps-parameterised update x_t -> x_{t-1}. Plan tables are float32
numpy in sampling order (descending t); ``step`` reads the per-step
scalars as Python floats.
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
