"""UniPC — unified predictor-corrector sampler (order 3, variant 'bh1'),
in PyTorch.

The port of the JAX package's ``diffusion/unipc.py``:
  * the discrete VP schedule's continuous-time marginals (log alpha
    interpolated piecewise-linearly over the discrete table);
  * the time-uniform ladder from t_T = strength (1 for txt2vid) to
    t_0 = 1/N;
  * the multistep bh1 predictor-corrector update, with every scalar
    coefficient (lambda/alpha/sigma at the rungs, the R-matrix solves for
    the predictor and corrector weights) computed on the host in float64;
  * a warm-up of rising order with the corrector, lower order on the final
    steps, and no corrector on the last step;
  * ``encode_vid2vid``: q-sample at t = strength.

The JAX package splits the loop into a warm-up, scanned windows of the
homogeneous order-3 middle and a tail so that ``lax.scan`` compiles the
UNet once (``_homo_tables``, ``_scan_homogeneous``, ``warmup``,
``homo_window``, ``tail``). PyTorch runs eagerly, so ``sample`` is one
Python loop over the rungs with the same order rule and corrector rule,
and reports each finished rung to ``on_step`` (the request's callback).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from t2v_torch.core.profiling import span
from t2v_torch.diffusion.schedules import DiffusionSchedule

NAME = "UniPC"
FRAME_INPAINT_SUPPORT = False
CFG_COMBINE = "full"
MULTISTEP = True  # carries model-output history: its own loop (``sample``)

ORDER = 3
VARIANT = "bh1"


@dataclass(frozen=True)
class Plan:
    """Continuous-time rungs and marginals, all length steps+1 (float64).
    Rung 0 is t_T (the start); rung ``steps`` is t_0 = 1/N."""

    t_cont: np.ndarray
    t_input: np.ndarray  # model input times: (t_cont - 1/N) * N (not integers)
    lam: np.ndarray  # lambda_t = log(alpha_t) - log(sigma_t)
    alpha: np.ndarray  # marginal alpha_t (continuous-time, = sqrt(cumprod))
    sigma: np.ndarray  # marginal sigma_t
    steps: int


def _discrete_marginals(schedule: DiffusionSchedule, t: np.ndarray):
    """log alpha_t by piecewise-linear interpolation of the discrete table."""
    n = schedule.num_timesteps
    t_array = np.linspace(0.0, 1.0, n + 1)[1:]
    log_alpha_array = 0.5 * np.log(schedule.alphas_cumprod_f64)
    log_alpha = np.interp(t, t_array, log_alpha_array)
    alpha = np.exp(log_alpha)
    sigma = np.sqrt(1.0 - np.exp(2.0 * log_alpha))
    lam = log_alpha - np.log(sigma)
    return log_alpha, alpha, sigma, lam


def plan(schedule: DiffusionSchedule, steps: int, t_start: float | None = None) -> Plan:
    n = schedule.num_timesteps
    t_0 = 1.0 / n
    t_T = 1.0 if t_start is None else float(t_start)
    t_cont = np.linspace(t_T, t_0, steps + 1)
    _, alpha, sigma, lam = _discrete_marginals(schedule, t_cont)
    return Plan(t_cont=t_cont, t_input=(t_cont - 1.0 / n) * n, lam=lam, alpha=alpha,
                sigma=sigma, steps=steps)


def encode_vid2vid(schedule: DiffusionSchedule, latent, noise, strength: float, steps: int):
    """q-sample at t = strength."""
    p = plan(schedule, steps, t_start=strength)
    return float(p.alpha[0]) * latent + float(p.sigma[0]) * noise


def _step_coeffs(p: Plan, s: int, order_s: int):
    """Host float64 coefficients of the update stepping to rung s:
    (rks, c_x, c_m, aB, rhos_p, rhos_c)."""
    lam = p.lam
    h = lam[s] - lam[s - 1]
    rks = np.array([(lam[s - 1 - i] - lam[s - 1]) / h for i in range(1, order_s)] + [1.0])
    hh = -h  # predict_x0
    h_phi_1 = np.expm1(hh)
    h_phi_k = h_phi_1 / hh - 1.0
    B_h = hh if VARIANT == "bh1" else np.expm1(hh)

    R, b = [], []
    factorial_i = 1.0
    for i in range(1, order_s + 1):
        R.append(np.power(rks, i - 1))
        b.append(h_phi_k * factorial_i / B_h)
        factorial_i *= i + 1
        h_phi_k = h_phi_k / hh - 1.0 / factorial_i
    R = np.stack(R)
    b = np.asarray(b)

    if order_s == 1:
        rhos_p = np.zeros(0)
    elif order_s == 2:
        rhos_p = np.array([0.5])
    else:
        rhos_p = np.linalg.solve(R[:-1, :-1], b[:-1])
    rhos_c = np.array([0.5]) if order_s == 1 else np.linalg.solve(R, b)

    c_x = p.sigma[s] / p.sigma[s - 1]
    c_m = p.alpha[s] * h_phi_1
    aB = p.alpha[s] * B_h
    return rks, c_x, c_m, aB, rhos_p, rhos_c


def _update(x, models, s: int, order_s: int, use_corrector: bool, p: Plan, model_fn):
    """One multistep bh-update to rung s. ``models`` holds the
    x0-predictions at the previous rungs, newest last. Returns (x_t, the
    model's prediction at the predicted x_t, or None without corrector)."""
    rks, c_x, c_m, aB, rhos_p, rhos_c = _step_coeffs(p, s, order_s)
    c_x, c_m, aB = float(c_x), float(c_m), float(aB)
    m0 = models[-1]
    d1s = [(models[-1 - i] - m0) / float(rks[i - 1]) for i in range(1, order_s)]

    x_t_ = c_x * x - c_m * m0
    pred = sum(float(w) * d for w, d in zip(rhos_p, d1s)) if d1s else 0.0
    x_t = x_t_ - aB * pred

    if not use_corrector:
        return x_t, None
    m_t = model_fn(x_t, p.t_input[s], s)
    corr = sum(float(w) * d for w, d in zip(rhos_c[:-1], d1s)) if d1s else 0.0
    x_t = x_t_ - aB * (corr + float(rhos_c[-1]) * (m_t - m0))
    return x_t, m_t


def order_at(s: int, steps: int) -> int:
    """The update's order at rung s: rising during the warm-up, then ORDER,
    falling again over the last rungs (lower_order_final)."""
    return s if s < ORDER else min(ORDER, steps + 1 - s)


def sample(x, model_fn: Callable, p: Plan, on_step: Callable[[int], None] | None = None):
    """Run the UniPC multistep loop. ``model_fn(x, t_input, s)`` is the
    x0 ("data") prediction at rung s with CFG applied. The corrector runs at
    every rung but the last, and its model call is the next rung's history
    entry, so a run of ``steps`` rungs makes ``steps`` model calls.
    ``on_step(s)`` is called after rung s is reached."""
    steps = p.steps
    models = [model_fn(x, p.t_input[0], 0)]
    for s in range(1, steps + 1):
        with span("t2v.step"):
            x, m = _update(x, models, s, order_at(s, steps), s < steps, p, model_fn)
            if s < steps:
                models = [*models, m][-ORDER:]
            if on_step is not None:
                on_step(s)
    return x
