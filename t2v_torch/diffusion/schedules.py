"""Diffusion noise schedules and the DDPM coefficient tables the port's
samplers read: the part of the JAX package's ``diffusion/schedules.py``
that the port's samplers need (the beta schedules, the DDPM posterior, the
ModelScope stride ladder, the SD-style DDIM timestep and sigma tables).

Tables are computed once on the host in float64 (the reference's
``torch.float64`` beta math, t2v_model.py:1240-1249) and exposed as float32
numpy arrays; the sampler reads per-step scalars from them.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np


def beta_schedule(
    schedule: str,
    num_timesteps: int = 1000,
    init_beta: float | None = None,
    last_beta: float | None = None,
) -> np.ndarray:
    """Beta arrays in float64. 'linear_sd' is the ModelScope schedule:
    linspace in sqrt-space; 'linear' (the LVDM one) is the same form with
    other default endpoints; 'cosine' is the improved-DDPM schedule;
    'sqrt_linear' is linear in beta."""
    if schedule in ("linear_sd", "linear"):
        lo, hi = (0.00085, 0.0120) if schedule == "linear_sd" else (1e-4, 2e-2)
        init_beta = lo if init_beta is None else init_beta
        last_beta = hi if last_beta is None else last_beta
        return np.linspace(init_beta**0.5, last_beta**0.5, num_timesteps, dtype=np.float64) ** 2
    if schedule == "cosine":
        s = 0.008
        x = np.linspace(0, num_timesteps, num_timesteps + 1, dtype=np.float64)
        alphas_cumprod = np.cos(((x / num_timesteps) + s) / (1 + s) * np.pi * 0.5) ** 2
        alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
        betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
        return np.clip(betas, 0, 0.999)
    if schedule == "sqrt_linear":
        init_beta = 1e-4 if init_beta is None else init_beta
        last_beta = 2e-2 if last_beta is None else last_beta
        return np.linspace(init_beta, last_beta, num_timesteps, dtype=np.float64)
    raise ValueError(f"Unsupported schedule: {schedule}")


@dataclass(frozen=True)
class DiffusionSchedule:
    """DDPM coefficient tables, float32, length ``num_timesteps`` (the
    buffers of reference gaussian_sampler.py:33-50 that DDIM reads)."""

    betas: np.ndarray

    @classmethod
    def from_betas(cls, betas: np.ndarray) -> "DiffusionSchedule":
        return cls(betas=np.asarray(betas, dtype=np.float64))

    @classmethod
    def linear_sd(cls, num_timesteps: int = 1000) -> "DiffusionSchedule":
        """ModelScope default (t2v_pipeline.py:107-111)."""
        return cls.from_betas(beta_schedule("linear_sd", num_timesteps))

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    @cached_property
    def _alphas_cumprod64(self) -> np.ndarray:
        return np.cumprod(1.0 - self.betas)

    @property
    def alphas_cumprod_f64(self) -> np.ndarray:
        """The float64 table the UniPC and DPM++ marginals interpolate."""
        return self._alphas_cumprod64

    @property
    def alphas_cumprod(self) -> np.ndarray:
        return self._alphas_cumprod64.astype(np.float32)

    @property
    def sqrt_alphas_cumprod(self) -> np.ndarray:
        """q-sample signal coefficient (the training step reads it)."""
        return np.sqrt(self._alphas_cumprod64).astype(np.float32)

    @property
    def sqrt_one_minus_alphas_cumprod(self) -> np.ndarray:
        """q-sample noise coefficient."""
        return np.sqrt(1.0 - self._alphas_cumprod64).astype(np.float32)

    @property
    def sqrt_recip_alphas_cumprod(self) -> np.ndarray:
        return np.sqrt(1.0 / self._alphas_cumprod64).astype(np.float32)

    @property
    def sqrt_recipm1_alphas_cumprod(self) -> np.ndarray:
        return np.sqrt(1.0 / self._alphas_cumprod64 - 1.0).astype(np.float32)

    @cached_property
    def _posterior64(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """q(x_{t-1} | x_t, x0): the mean's two coefficients and the
        variance (float64; 0 at t = 0)."""
        ac = self._alphas_cumprod64
        ac_prev = np.concatenate([[1.0], ac[:-1]])
        return (self.betas * np.sqrt(ac_prev) / (1.0 - ac),
                (1.0 - ac_prev) * np.sqrt(1.0 - self.betas) / (1.0 - ac),
                self.betas * (1.0 - ac_prev) / (1.0 - ac))

    @property
    def posterior_mean_coef1(self) -> np.ndarray:
        """Weight of the x0 prediction in the posterior mean."""
        return self._posterior64[0].astype(np.float32)

    @property
    def posterior_mean_coef2(self) -> np.ndarray:
        """Weight of x_t in the posterior mean."""
        return self._posterior64[1].astype(np.float32)

    @property
    def posterior_log_variance_clipped(self) -> np.ndarray:
        """log of the posterior variance, clipped below at 1e-20."""
        return np.log(np.maximum(self._posterior64[2], 1e-20)).astype(np.float32)


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


def make_ddim_timesteps(num_ddim_timesteps: int, num_ddpm_timesteps: int,
                        discr_method: str = "uniform") -> np.ndarray:
    """SD-style DDIM timestep subset (ascending), ldm util semantics:
    uniform: arange(0, T, T // steps) + 1."""
    if num_ddim_timesteps > num_ddpm_timesteps:
        raise ValueError(
            f"steps ({num_ddim_timesteps}) cannot exceed the schedule's "
            f"num_timesteps ({num_ddpm_timesteps})"
        )
    if discr_method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        ddim_timesteps = np.asarray(list(range(0, num_ddpm_timesteps, c)))
    elif discr_method == "quad":
        ddim_timesteps = (
            np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8), num_ddim_timesteps) ** 2
        ).astype(int)
    else:
        raise NotImplementedError(discr_method)
    return (ddim_timesteps + 1).astype(np.int32)


def make_ddim_sampling_parameters(
    alphacums: np.ndarray, ddim_timesteps: np.ndarray, eta: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(sigmas, alphas, alphas_prev) for the selected DDIM subset (ldm util
    make_ddim_sampling_parameters semantics)."""
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.concatenate([[alphacums[0]], alphacums[ddim_timesteps[:-1]]])
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return (sigmas.astype(np.float32), alphas.astype(np.float32), alphas_prev.astype(np.float32))
