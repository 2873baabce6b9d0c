"""DDIM_Gaussian — the ModelScope-style DDIM sampler (the reference
default), in PyTorch.

The port of the JAX package's ``diffusion/ddim_gaussian.py``: the stride
timestep ladder, CFG on the first C//2 output channels only (the learned
variance split), eps -> x0 -> DDIM update with eta noise gated off at t=0.
Plan tables are float32 numpy; ``step`` reads the per-step scalars as
Python floats.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from t2v_torch.diffusion.schedules import DiffusionSchedule, modelscope_timesteps

NAME = "DDIM_Gaussian"
CFG_COMBINE = "split_learned_range"


@dataclass(frozen=True)
class Plan:
    """Per-step coefficient tables, each shaped (steps,)."""

    timesteps: np.ndarray  # int32, descending DDPM t visited per step
    alphas: np.ndarray
    alphas_prev: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    sigmas: np.ndarray  # eta-scaled DDIM sigma per step
    steps: int


def plan(schedule: DiffusionSchedule, steps: int, eta: float = 0.0) -> Plan:
    T = schedule.num_timesteps
    stride = T // steps
    ts = modelscope_timesteps(T, steps)
    t_prev = np.clip(ts - stride, 0, None)
    alphas = schedule.alphas_cumprod[ts]
    alphas_prev = schedule.alphas_cumprod[t_prev]
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return Plan(
        timesteps=ts,
        alphas=alphas.astype(np.float32),
        alphas_prev=alphas_prev.astype(np.float32),
        sqrt_recip_alphas_cumprod=schedule.sqrt_recip_alphas_cumprod[ts],
        sqrt_recipm1_alphas_cumprod=schedule.sqrt_recipm1_alphas_cumprod[ts],
        sigmas=sigmas.astype(np.float32),
        steps=steps,
    )


def step(x: torch.Tensor, eps: torch.Tensor, p: Plan, i: int, noise) -> torch.Tensor:
    """One DDIM update x_t -> x_{t-1}; ``noise`` (standard normal, x's
    shape) is read only when the step's sigma is non-zero."""
    a_prev = np.float32(p.alphas_prev[i])
    sigma = np.float32(p.sigmas[i])
    eps = eps.to(x.dtype)
    x0 = float(p.sqrt_recip_alphas_cumprod[i]) * x - float(p.sqrt_recipm1_alphas_cumprod[i]) * eps
    direction = float(np.sqrt(np.float32(1.0) - a_prev - sigma * sigma)) * eps
    out = float(np.sqrt(a_prev)) * x0 + direction
    if sigma != 0 and int(p.timesteps[i]) != 0:
        out = out + float(sigma) * noise
    return out
