"""Plain reference of the two samplers the cells run, eta = 0.

* ``ddim_gaussian`` (ModelScope's default): the 1000-step "linear_sd"
  schedule (betas linear in sqrt space from 0.00085 to 0.012); timesteps
  ``flip(clip(1 + arange(0, T, T // steps), 0, T - 1))[:steps]``; the next
  timestep ``max(t - T // steps, 0)``; classifier-free guidance on the first
  C // 2 output channels (the rest from the conditional branch);
  x0 = √(1/ᾱ_t)·x − √(1/ᾱ_t − 1)·ε, x' = √ᾱ_prev·x0 + √(1 − ᾱ_prev)·ε.
* ``ddim`` (VideoCrafter's default): the same schedule; timesteps
  ``arange(0, T, T // steps) + 1`` (clipped to T - 1), visited in descending
  order; ᾱ_prev of the first rung is ᾱ_0; full-channel guidance;
  x0 = (x − √(1 − ᾱ_t)·ε) / √ᾱ_t, x' = √ᾱ_prev·x0 + √(1 − ᾱ_prev)·ε.

Timesteps and ᾱ come from float64 tables, rounded to float32 as the
published samplers hold them.
"""

from __future__ import annotations

import numpy as np
import torch

T = 1000


def alphas_cumprod() -> np.ndarray:
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, T, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def plan(sampler: str, steps: int) -> list[tuple[int, float, float]]:
    """(t, ᾱ_t, ᾱ_prev) per step, in sampling order."""
    ac = alphas_cumprod()
    if sampler == "DDIM_Gaussian":
        stride = T // steps
        ts = np.clip(1 + np.arange(0, T, stride), 0, T - 1)[::-1][:steps]
        prev = np.clip(ts - stride, 0, None)
        return [(int(t), float(ac[t]), float(np.float32(ac[p]))) for t, p in zip(ts, prev)]
    if sampler == "DDIM":
        ts = np.minimum(np.arange(0, T, T // steps) + 1, T - 1)
        prev = np.concatenate([[ac[0]], ac[ts[:-1]]])
        rungs = [(int(t), float(np.float32(ac[t])), float(np.float32(p))) for t, p in zip(ts, prev)]
        return rungs[::-1]
    raise ValueError(f"no reference for sampler {sampler!r}")


def guide(sampler: str, out: torch.Tensor, scale: float) -> torch.Tensor:
    """Combine a [uncond; cond] model output of 2·B rows into B rows."""
    u, y = out.float().chunk(2, dim=0)
    if sampler == "DDIM_Gaussian":
        d = y.shape[-1] // 2
        return torch.cat([u[..., :d] + scale * (y[..., :d] - u[..., :d]), y[..., d:]], dim=-1)
    return u + scale * (y - u)


def step(sampler: str, x: torch.Tensor, eps: torch.Tensor, rung) -> torch.Tensor:
    """One eta = 0 update of the float32 state x at ``rung`` = (t, ᾱ_t, ᾱ_prev)."""
    t, a, a_prev = rung
    eps = eps.float()[..., : x.shape[-1]]
    if sampler == "DDIM_Gaussian":
        x0 = np.sqrt(1.0 / a) * x - np.sqrt(1.0 / a - 1.0) * eps
    else:
        x0 = (x - np.sqrt(1.0 - a) * eps) / np.sqrt(a)
    return np.sqrt(a_prev) * x0 + np.sqrt(1.0 - a_prev) * eps
