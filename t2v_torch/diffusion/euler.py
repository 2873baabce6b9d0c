"""Euler and Euler-ancestral ("Euler a") samplers, k-diffusion convention,
in PyTorch.

The port of the JAX package's ``diffusion/euler.py``. k-diffusion steps
the rescaled state ``x_k = x_vp / sqrt(abar_t)`` along noise-to-signal
levels ``sig_t = sqrt(1 - abar_t) / sqrt(abar_t)``, where the Euler
derivative is exactly the eps prediction. Mapped back to the VP state
every step is a 3-coefficient affine update precomputed on the host:

    x' = ratio * x + c_eps * eps (+ c_noise * noise)

with ``sig_dn = sig_next`` (Euler) or the ancestral split of ``sig_next``
into ``sig_dn`` and ``sig_up`` with eta 1 (Euler a). The final rung is
(abar=1, sig=0): the last step lands on the x0 prediction.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from t2v_torch.diffusion.schedules import DiffusionSchedule, make_ddim_timesteps

NAME = "Euler"
FRAME_INPAINT_SUPPORT = False
CFG_COMBINE = "full"
# plain Euler ignores eta (c_noise == 0): the loop draws no step noise for it
USES_ETA = False


@dataclass(frozen=True)
class Plan:
    """Per-step affine tables in sampling order (descending t), (steps,)."""

    timesteps: np.ndarray  # int32, descending: model input t per step
    ratio: np.ndarray  # sqrt(abar_next)/sqrt(abar_cur)
    c_eps: np.ndarray  # sqrt(abar_next) * (sig_dn - sig_cur)
    c_noise: np.ndarray  # sqrt(abar_next) * sig_up  (zero for plain Euler)
    steps: int


def _levels(schedule: DiffusionSchedule, steps: int):
    """Descending model-input timesteps and the (abar, sig) ladder with the
    terminal clean rung (abar=1, sig=0)."""
    ts_asc = np.minimum(
        make_ddim_timesteps(steps, schedule.num_timesteps), schedule.num_timesteps - 1
    )
    ts = np.ascontiguousarray(ts_asc[::-1]).astype(np.int32)
    abar = np.concatenate([schedule.alphas_cumprod[ts], [1.0]])
    sig = np.sqrt(1.0 - abar) / np.sqrt(abar)
    return ts, abar, sig


def _make_plan(schedule: DiffusionSchedule, steps: int, ancestral: bool) -> Plan:
    ts, abar, sig = _levels(schedule, steps)
    steps = len(ts)
    sqrt_ab = np.sqrt(abar)
    sig_cur, sig_next = sig[:-1], sig[1:]
    if ancestral:
        # k-diffusion get_ancestral_step with eta=1
        sig_up = np.minimum(
            sig_next,
            np.sqrt(np.clip(sig_next**2 * (sig_cur**2 - sig_next**2), 0.0, None))
            / np.where(sig_cur > 0, sig_cur, 1.0),
        )
        sig_dn = np.sqrt(np.clip(sig_next**2 - sig_up**2, 0.0, None))
    else:
        sig_up = np.zeros(steps)
        sig_dn = sig_next
    return Plan(
        timesteps=ts,
        ratio=(sqrt_ab[1:] / sqrt_ab[:-1]).astype(np.float32),
        c_eps=(sqrt_ab[1:] * (sig_dn - sig_cur)).astype(np.float32),
        c_noise=(sqrt_ab[1:] * sig_up).astype(np.float32),
        steps=steps,
    )


def plan(schedule: DiffusionSchedule, steps: int, eta: float = 0.0) -> Plan:
    """``eta`` is taken for the protocol and ignored: Euler is
    deterministic, and the ancestral variant's noise scale is structural."""
    return _make_plan(schedule, steps, ancestral=False)


def step(x: torch.Tensor, eps: torch.Tensor, p: Plan, i: int, noise) -> torch.Tensor:
    """One affine update; ``noise`` (standard normal, x's shape) is read only
    when the step's c_noise is non-zero."""
    out = float(p.ratio[i]) * x + float(p.c_eps[i]) * eps.to(x.dtype)
    if p.c_noise[i] != 0:
        out = out + float(p.c_noise[i]) * noise
    return out


def encode_vid2vid(schedule: DiffusionSchedule, latent, noise, strength: float, steps: int):
    """q-sample the source at the plan's top rung (the caller shortens the
    plan by its skip steps first, as the ModelScope runner does)."""
    ts, _, _ = _levels(schedule, max(int(steps), 1))
    t_top = int(ts[0])
    sa = float(schedule.sqrt_alphas_cumprod[t_top])
    sb = float(schedule.sqrt_one_minus_alphas_cumprod[t_top])
    return sa * latent + sb * noise


class _AncestralVariant:
    """Registry adapter for "Euler a": the same protocol, with ancestral
    noise drawn every step (NEEDS_STEP_NOISE)."""

    NAME = "Euler a"
    FRAME_INPAINT_SUPPORT = False
    CFG_COMBINE = "full"
    NEEDS_STEP_NOISE = True
    Plan = Plan
    step = staticmethod(step)
    encode_vid2vid = staticmethod(encode_vid2vid)

    @staticmethod
    def plan(schedule, steps, eta=0.0):
        return _make_plan(schedule, steps, ancestral=True)


ancestral = _AncestralVariant()
