"""DPM-Solver++(2M): multistep second-order ODE sampler (data prediction),
on uniform or Karras rho-7 rungs, in PyTorch.

The port of the JAX package's ``diffusion/dpmpp.py``. Stepping rung i to
i+1 with h_i = lam_{i+1} - lam_i:

    D_i    = x0-prediction at rung i
    Dbar_0 = D_0                                   (first step: 1st order)
    Dbar_i = (1 + 1/(2 r_i)) D_i - 1/(2 r_i) D_{i-1},  r_i = h_{i-1}/h_i
    x_{i+1} = (sigma_{i+1}/sigma_i) x_i + alpha_{i+1} (1 - e^{-h_i}) Dbar_i

The continuous-time marginals are UniPC's, so ``sampling._unipc_model_fn``
is the x0-prediction wrapper. The JAX package's ``window`` carried
(x, previous D) across jitted windows; here ``sample`` is one Python loop
that reports each finished step to ``on_step``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from t2v_torch.core.profiling import span
from t2v_torch.diffusion.schedules import DiffusionSchedule
from t2v_torch.diffusion.unipc import _discrete_marginals

NAME = "DPM++ 2M"
FRAME_INPAINT_SUPPORT = False
CFG_COMBINE = "full"
MULTISTEP = True  # carries model-output history: its own loop (``sample``)


@dataclass(frozen=True)
class Plan:
    """Rungs 0..steps (float64 host tables); model calls at rungs
    0..steps-1. ``alpha``/``sigma``/``t_input`` have steps+1 entries, as
    ``sampling._unipc_model_fn`` reads them."""

    t_input: np.ndarray  # model input times per rung
    alpha: np.ndarray  # marginal alpha_t per rung
    sigma: np.ndarray  # marginal sigma_t per rung
    sig_ratio: np.ndarray  # (steps,) sigma_{i+1}/sigma_i
    growth: np.ndarray  # (steps,) alpha_{i+1} * (1 - exp(-h_i))
    c_cur: np.ndarray  # (steps,) Dbar weight on D_i
    c_prev: np.ndarray  # (steps,) Dbar weight on D_{i-1}
    steps: int


def _karras_rungs(schedule: DiffusionSchedule, steps: int, t_T: float, t_0: float,
                  rho: float = 7.0) -> np.ndarray:
    """Karras et al. 2022 (eq. 5) node spacing on the noise-to-signal ratio
    sigma/alpha = exp(-lambda), mapped back to continuous time by inverting
    the discrete schedule's lambda(t) on a fine grid."""
    _, _, _, lam_ends = _discrete_marginals(schedule, np.array([t_T, t_0]))
    nsr = np.exp(-lam_ends)
    u = np.linspace(0.0, 1.0, steps + 1)
    ramp = (nsr[0] ** (1 / rho) + u * (nsr[1] ** (1 / rho) - nsr[0] ** (1 / rho))) ** rho
    lam_target = -np.log(ramp)
    # lambda decreases in t and np.interp needs ascending abscissae
    t_grid = np.linspace(t_0, t_T, 4096)
    _, _, _, lam_grid = _discrete_marginals(schedule, t_grid)
    return np.interp(lam_target, lam_grid[::-1], t_grid[::-1])


def plan(schedule: DiffusionSchedule, steps: int, t_start: float | None = None,
         node_schedule: str = "uniform") -> Plan:
    n = schedule.num_timesteps
    t_0 = 1.0 / n
    t_T = 1.0 if t_start is None else float(t_start)
    if node_schedule == "karras":
        t_cont = _karras_rungs(schedule, steps, t_T, t_0)
    else:
        t_cont = np.linspace(t_T, t_0, steps + 1)
    _, alpha, sigma, lam = _discrete_marginals(schedule, t_cont)

    h = lam[1:] - lam[:-1]
    c_cur = np.ones(steps)
    c_prev = np.zeros(steps)
    if steps > 1:
        r = h[:-1] / h[1:]
        c_cur[1:] = 1.0 + 1.0 / (2.0 * r)
        c_prev[1:] = -1.0 / (2.0 * r)
    return Plan(
        t_input=(t_cont - 1.0 / n) * n,
        alpha=alpha,
        sigma=sigma,
        sig_ratio=sigma[1:] / sigma[:-1],
        growth=alpha[1:] * (1.0 - np.exp(-h)),
        c_cur=c_cur,
        c_prev=c_prev,
        steps=steps,
    )


def encode_vid2vid(schedule: DiffusionSchedule, latent, noise, strength: float, steps: int):
    """q-sample at t = strength, as UniPC's entry does."""
    p = plan(schedule, steps, t_start=strength)
    return float(p.alpha[0]) * latent + float(p.sigma[0]) * noise


def sample(x, model_fn: Callable, p: Plan, on_step: Callable[[int], None] | None = None):
    """Run the 2M loop. ``model_fn(x, t_input, s)`` is the x0 prediction at
    rung s (``sampling._unipc_model_fn``); ``on_step(i + 1)`` is called after
    step i."""
    d_prev = torch.zeros_like(x)
    for i in range(p.steps):
        with span("t2v.step"):
            d = model_fn(x, p.t_input[i], i)
            d_bar = float(p.c_cur[i]) * d + float(p.c_prev[i]) * d_prev
            x = float(p.sig_ratio[i]) * x + float(p.growth[i]) * d_bar
            d_prev = d
            if on_step is not None:
                on_step(i + 1)
    return x


class _KarrasVariant:
    """Registry adapter: the same 2M solver on Karras rho-7 rungs
    ("DPM++ 2M Karras")."""

    NAME = "DPM++ 2M Karras"
    FRAME_INPAINT_SUPPORT = False
    CFG_COMBINE = "full"
    MULTISTEP = True
    Plan = Plan
    sample = staticmethod(sample)

    @staticmethod
    def plan(schedule, steps, t_start=None):
        return plan(schedule, steps, t_start, node_schedule="karras")

    @staticmethod
    def encode_vid2vid(schedule, latent, noise, strength, steps):
        p = plan(schedule, steps, t_start=strength, node_schedule="karras")
        return float(p.alpha[0]) * latent + float(p.sigma[0]) * noise


karras = _KarrasVariant()
