"""Diffusion noise schedule and the DDPM coefficient tables the port's
samplers read: the part of the JAX package's ``diffusion/schedules.py``
that the DDIM_Gaussian path needs.

Tables are computed once on the host in float64 (the reference's
``torch.float64`` beta math, t2v_model.py:1240-1249) and exposed as float32
numpy arrays; the sampler reads per-step scalars from them.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np


def linear_sd_betas(num_timesteps: int = 1000) -> np.ndarray:
    """The ModelScope schedule in float64: linspace in sqrt-space from
    0.00085 to 0.0120 (t2v_model.py:1243-1246)."""
    return np.linspace(0.00085**0.5, 0.0120**0.5, num_timesteps, dtype=np.float64) ** 2


@dataclass(frozen=True)
class DiffusionSchedule:
    """DDPM coefficient tables, float32, length ``num_timesteps`` (the
    buffers of reference gaussian_sampler.py:33-50 that DDIM reads)."""

    betas: np.ndarray

    @classmethod
    def linear_sd(cls, num_timesteps: int = 1000) -> "DiffusionSchedule":
        """ModelScope default (t2v_pipeline.py:107-111)."""
        return cls(betas=linear_sd_betas(num_timesteps))

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    @cached_property
    def _alphas_cumprod64(self) -> np.ndarray:
        return np.cumprod(1.0 - self.betas)

    @property
    def alphas_cumprod(self) -> np.ndarray:
        return self._alphas_cumprod64.astype(np.float32)

    @property
    def sqrt_recip_alphas_cumprod(self) -> np.ndarray:
        return np.sqrt(1.0 / self._alphas_cumprod64).astype(np.float32)

    @property
    def sqrt_recipm1_alphas_cumprod(self) -> np.ndarray:
        return np.sqrt(1.0 / self._alphas_cumprod64 - 1.0).astype(np.float32)


def modelscope_timesteps(num_timesteps: int, steps: int) -> np.ndarray:
    """The DDIM_Gaussian sampler's timestep ladder.

    Reproduces gaussian_sampler.py:75-88: stride = T//steps,
    ladder = flip(clamp(1 + arange(0, T, stride), 0, T-1)); the sampler then
    uses entries [0, steps) of the flipped ladder. Returns the ``steps``
    timesteps actually visited, descending.
    """
    if steps > num_timesteps:
        raise ValueError(
            f"steps ({steps}) cannot exceed the schedule's num_timesteps "
            f"({num_timesteps})"
        )
    stride = num_timesteps // steps
    ladder = 1 + np.arange(0, num_timesteps, stride)
    ladder = np.clip(ladder, 0, num_timesteps - 1)
    return ladder[::-1][:steps].astype(np.int32)
