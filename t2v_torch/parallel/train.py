"""Diffusion training steps on one device.

The port of the JAX package's ``parallel/train.py``: one step = q-sample ->
prediction -> MSE against the parameterization's target -> AdamW -> EMA.
No mesh and no sharding here: the multi-GPU slice brings those.

Where JAX threads immutable trees through a jitted function, the port keeps
a ``TrainState`` whose leaves are updated **in place** by the step (the
optimizer's moments and the EMA shadow too): one copy of the state lives on
the device. ``init_train_state`` copies the parameters it is given, so the
pipeline's own weights are never written to. A state keeps its parameters
in the dtype it was given; the EMA shadow is float32.

A parameter tree is a dict of tensors, flat (a UNet's ``name -> tensor``)
or nested one level (a LoRA tree); ``apply_fn(params, x, t, context)`` runs
the model on such a flat dict (``module_apply_fn``). Randomness comes from
an explicit ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from t2v_torch.diffusion.schedules import DiffusionSchedule

Optimizer = Callable[[list[torch.Tensor]], torch.optim.Optimizer]


@dataclass
class TrainState:
    params: Any                      # dict of trainable leaves (flat, or a LoRA tree)
    opt_state: torch.optim.Optimizer  # AdamW over those leaves, moments inside
    step: int
    ema_params: Any = None           # float32 shadow of params, or None


def tree_items(tree) -> list[tuple[str, torch.Tensor]]:
    """(dotted name, tensor) of every tensor leaf, in insertion order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.extend((f"{k}.{kk}", vv) for kk, vv in tree_items(v))
        elif torch.is_tensor(v):
            out.append((k, v))
    return out


def tree_leaves(tree) -> list[torch.Tensor]:
    return [t for _, t in tree_items(tree)]


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else (fn(v) if torch.is_tensor(v) else v)
            for k, v in tree.items()}


def make_optimizer(lr: float = 1e-4, weight_decay: float = 1e-2) -> Optimizer:
    """AdamW as ``optax.adamw(lr, weight_decay=...)`` computes it: betas
    0.9 / 0.999, eps 1e-8, decoupled decay. Returns the constructor that
    ``init_train_state`` calls on the state's own leaves."""
    return partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                   weight_decay=weight_decay)


def module_apply_fn(module: torch.nn.Module) -> Callable:
    """``apply_fn(params, x, t, context)``: the module run on a flat
    ``name -> tensor`` dict in place of its own parameters."""
    return lambda params, x, t, context: functional_call(module, params, (x, t, context))


def schedule_tables(schedule: DiffusionSchedule, device="cpu") -> dict:
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return {
        "num_timesteps": schedule.num_timesteps,
        "sqrt_alphas_cumprod": as_t(schedule.sqrt_alphas_cumprod),
        "sqrt_one_minus_alphas_cumprod": as_t(schedule.sqrt_one_minus_alphas_cumprod),
    }


def diffusion_loss(apply_fn, params, tables, batch, generator: torch.Generator,
                   parameterization: str = "eps", draw=None):
    """Denoising MSE. The regression target follows the model's prediction
    parameterization: eps -> the noise; x0 -> the clean latent; v ->
    sqrt(abar_t) * eps - sqrt(1 - abar_t) * x0. ``draw`` hands in the
    ``(t, noise)`` that the generator would otherwise give (tests feed both
    packages the same draw)."""
    x0, context = batch["latents"], batch["context"]
    b = x0.shape[0]

    def loss_at(t, noise):
        bshape = (b,) + (1,) * (x0.dim() - 1)
        sqrt_ac = tables["sqrt_alphas_cumprod"][t].reshape(bshape)
        sqrt_1mac = tables["sqrt_one_minus_alphas_cumprod"][t].reshape(bshape)
        xt = sqrt_ac * x0 + sqrt_1mac * noise
        if parameterization == "x0":
            target = x0
        elif parameterization == "v":
            target = sqrt_ac * noise - sqrt_1mac * x0
        else:
            target = noise
        pred = apply_fn(params, xt, t.float(), context)
        return torch.mean((pred - target) ** 2)

    if draw is None:
        dev = x0.device
        t = torch.randint(0, tables["num_timesteps"], (b,), generator=generator, device=dev)
        noise = torch.randn(x0.shape, generator=generator, device=dev, dtype=x0.dtype)
        draw = (t, noise)
    return loss_at(*draw)


@torch.no_grad()
def _ema_update(ema, params, decay: float) -> None:
    """ema <- ema * decay + params * (1 - decay), in place, in float32."""
    shadow = tree_leaves(ema)
    torch._foreach_mul_(shadow, decay)
    torch._foreach_add_(shadow, [p.to(e.dtype) for p, e in zip(tree_leaves(params), shadow)],
                        alpha=1.0 - decay)


def _device_tables(schedule: DiffusionSchedule) -> Callable:
    """device -> the schedule's tables there, made once per device."""
    cache: dict = {}

    def get(device):
        if device not in cache:
            cache[device] = schedule_tables(schedule, device)
        return cache[device]

    return get


def _apply_gradients(state: TrainState, loss: torch.Tensor) -> None:
    leaves = tree_leaves(state.params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for p, g in zip(leaves, grads):
        # a leaf the loss does not reach still decays, as under optax
        p.grad = g if g is not None else torch.zeros_like(p)
    state.opt_state.step()
    state.opt_state.zero_grad(set_to_none=True)
    state.step += 1


def make_train_step(
    apply_fn: Callable,
    schedule: DiffusionSchedule,
    *,
    ema_decay: float | None = None,
    remat: bool = False,
    parameterization: str = "eps",
) -> Callable:
    """Returns ``train_step(state, batch, generator, draw=None) -> (state,
    loss)``; the state is updated in place and handed back.

    batch = {"latents": (B, F, H, W, C), "context": (B, L, D)} on the
    state's device. ``ema_decay`` updates the EMA shadow carried in
    ``state.ema_params``. ``remat=True`` rematerialises the UNet forward
    during the backward pass (``torch.utils.checkpoint``): about one more
    forward of work for the activation memory."""
    tables = _device_tables(schedule)
    if remat:
        inner = apply_fn
        apply_fn = lambda params, x, t, context: checkpoint(
            inner, params, x, t, context, use_reentrant=False, preserve_rng_state=False)

    def step(state: TrainState, batch, generator, draw=None):
        loss = diffusion_loss(apply_fn, state.params, tables(batch["latents"].device), batch,
                              generator, parameterization, draw)
        _apply_gradients(state, loss)
        if ema_decay is not None and state.ema_params is not None:
            _ema_update(state.ema_params, state.params, ema_decay)
        return state, loss.detach()

    return step


def init_train_state(params, optimizer: Optimizer, *, with_ema: bool = False) -> TrainState:
    """A state on copies of ``params`` (the caller's tensors, e.g. a
    pipeline's weights, are never written to), each asking for a gradient;
    AdamW's moments are made at the first step; the EMA shadow is float32."""
    params = tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
    ema = tree_map(lambda p: p.detach().float().clone(), params) if with_ema else None
    return TrainState(params=params, opt_state=optimizer(tree_leaves(params)), step=0,
                      ema_params=ema)


def make_lora_train_step(
    apply_fn: Callable,
    schedule: DiffusionSchedule,
    base_params,
    module_index,
    *,
    alpha: float = 1.0,
    parameterization: str = "eps",
) -> Callable:
    """LoRA fine-tuning step: ``state.params`` is the low-rank adapter tree
    (``pipeline/lora.py::init_lora``); the frozen base weights are merged
    functionally inside the loss, so only A and B receive gradients and the
    base tensors are never written to."""
    from t2v_torch.pipeline.lora import apply_lora

    base = {k: v.detach() for k, v in base_params.items()}
    tables = _device_tables(schedule)

    def step(state: TrainState, batch, generator, draw=None):
        merged = apply_lora(base, state.params, module_index, alpha)
        loss = diffusion_loss(apply_fn, merged, tables(batch["latents"].device), batch,
                              generator, parameterization, draw)
        _apply_gradients(state, loss)
        return state, loss.detach()

    return step
