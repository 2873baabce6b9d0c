"""Full-chain ancestral DDPM sampling, in PyTorch.

The port of the JAX package's ``diffusion/ddpm.py``, LVDM's ``ddpm``
sample type: all T timesteps from T - 1 down to 0, each step the posterior
q(x_{t-1} | x_t, x0) of the x0 that the model's eps predicts, with the
clipped log-variance, and no noise at t = 0.

``clip_denoised``: the pixel-space convention clips x0 to [-1, 1]; LVDM's
latent diffusion does not (its latents routinely exceed +-1), so the
VideoCrafter caller passes ``clip_denoised=False``.

Randomness: step i's noise is ``noise_table[i]`` when a table is given
(tests hand in the JAX chain's own draws, ``fold_in(stream(key,
"ddpm_noise"), i)``), else a draw from ``generator``. The state stays
float32 whatever the model's dtype.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from t2v_torch.core.profiling import span
from t2v_torch.diffusion.schedules import DiffusionSchedule

NAME = "DDPM"
CFG_COMBINE = "full"


@torch.no_grad()
def sample(eps_fn: Callable, schedule: DiffusionSchedule, x: torch.Tensor, *,
           generator: torch.Generator | None = None,
           noise_table: Sequence[torch.Tensor] | None = None,
           clip_denoised: bool = True) -> torch.Tensor:
    """``eps_fn(x, t, step) -> eps``; runs t = T - 1 .. 0 from ``x``."""
    T = schedule.num_timesteps
    sr, srm1 = schedule.sqrt_recip_alphas_cumprod, schedule.sqrt_recipm1_alphas_cumprod
    pm1, pm2 = schedule.posterior_mean_coef1, schedule.posterior_mean_coef2
    std = np.exp(0.5 * schedule.posterior_log_variance_clipped)
    x = x.float()
    for i in range(T):
        with span("t2v.step"):
            t = T - 1 - i
            eps = eps_fn(x, float(t), i).float()
            x0 = float(sr[t]) * x - float(srm1[t]) * eps
            if clip_denoised:
                x0 = x0.clamp(-1.0, 1.0)
            mean = float(pm1[t]) * x0 + float(pm2[t]) * x
            if t == 0:
                x = mean
                continue
            if noise_table is not None:
                noise = torch.as_tensor(noise_table[i]).to(device=x.device, dtype=torch.float32)
            else:
                noise = torch.randn(x.shape, generator=generator, device=x.device,
                                    dtype=torch.float32)
            x = mean + float(std[t]) * noise
    return x
