"""Diffusion training steps, on one device or over a dp x sp x tp process
mesh.

The port of the JAX package's ``parallel/train.py``: one step = q-sample ->
prediction -> MSE against the parameterization's target -> AdamW -> EMA.

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

Over a mesh (``parallel/mesh.py``; ``mesh=None`` is one device) a step
computes what XLA's partitioner gives the JAX package: the serial step on
the global batch.

  * Each dp rank takes its contiguous share of the global batch's samples
    and each sp rank its share of the frames: a step is handed this rank's
    share (``local_batch`` cuts it from a global batch, and refuses a batch
    that dp or frames that sp do not divide).
  * Every rank draws the global ``(t, noise)`` from the shared generator,
    in the serial step's order, and keeps its share, so the draws do not
    depend on the mesh (``draw=`` hands in the global pair).
  * The loss is the global mean: a rank's term is its squared-error sum
    over the global element count, and the loss reported is the sum of the
    terms over dp and sp.
  * Each rank differentiates its own term; the collectives inside the UNet
    give it the gradient of the whole loss with respect to its own tensors
    (``parallel/mesh.py``). A state leaf's gradient is then summed over sp
    and dp (``Axis.all_reduce_buckets``: float32 buckets), and a whole LoRA
    factor that feeds one tp slice of a weight also over tp.
  * A state holds this rank's tp pieces (``sharding.tp_layout``), so AdamW
    and the EMA, elementwise, update each piece as the serial step updates
    the whole tensor.

A step is ``loss_and_grads`` (the reported loss and this rank's final
gradients) followed by ``apply_gradients`` (AdamW, the step counter, the
EMA).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from t2v_torch.diffusion.schedules import DiffusionSchedule
from t2v_torch.parallel import audit
from t2v_torch.parallel.sharding import parallel_unet, shard_params, shard_tensor

Optimizer = Callable[[list[torch.Tensor]], torch.optim.Optimizer]


@dataclass
class TrainState:
    params: Any                      # dict of trainable leaves (flat, or a LoRA tree)
    opt_state: torch.optim.Optimizer  # AdamW over those leaves, moments inside
    step: int
    ema_params: Any = None           # float32 shadow of params, or None
    mesh: Any = None                 # the ProcessMesh the state was cut for, or None
    layout: dict = field(default_factory=dict)  # the leaves held as tp pieces (tp_layout)


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


def module_apply_fn(module: torch.nn.Module, mesh=None) -> Callable:
    """``apply_fn(params, x, t, context)``: the module run on a flat
    ``name -> tensor`` dict in place of its own parameters. With a mesh
    the module runs inside ``parallel_unet`` on this rank's tp pieces and
    frames (the dict must then hold every parameter, as a train state's
    pieces do)."""
    if mesh is None:
        return lambda params, x, t, context: functional_call(module, params, (x, t, context))

    def apply(params, x, t, context):
        with parallel_unet(module, tp=mesh.tp, sp=mesh.sp, weights=False):
            return functional_call(module, params, (x, t, context))

    return apply


def schedule_tables(schedule: DiffusionSchedule, device="cpu") -> dict:
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return {
        "num_timesteps": schedule.num_timesteps,
        "sqrt_alphas_cumprod": as_t(schedule.sqrt_alphas_cumprod),
        "sqrt_one_minus_alphas_cumprod": as_t(schedule.sqrt_one_minus_alphas_cumprod),
    }


def local_batch(mesh, batch: dict) -> dict:
    """This rank's share of a global batch {"latents": (B, F, H, W, C),
    "context": (B, L, D)}: its dp index's samples, its sp index's frames.
    Raises ValueError unless dp divides the batch and sp the frames (as the
    JAX step's sharding constraint fails there)."""
    if mesh is None:
        return batch
    lat, ctx = batch["latents"], batch["context"]
    if lat.shape[0] % mesh.dp.size:
        raise ValueError(f"the batch size ({lat.shape[0]}) does not divide by dp "
                         f"({mesh.dp.size})")
    if lat.shape[1] % mesh.sp.size:
        raise ValueError(f"the frame count ({lat.shape[1]}) does not divide by sp "
                         f"({mesh.sp.size})")
    return {"latents": mesh.sp.shard(mesh.dp.shard(lat, 0), 1).contiguous(),
            "context": mesh.dp.shard(ctx, 0).contiguous()}


def diffusion_loss(apply_fn, params, tables, batch, generator: torch.Generator,
                   parameterization: str = "eps", draw=None, mesh=None):
    """Denoising MSE. The regression target follows the model's prediction
    parameterization: eps -> the noise; x0 -> the clean latent; v ->
    sqrt(abar_t) * eps - sqrt(1 - abar_t) * x0. ``draw`` hands in the
    ``(t, noise)`` that the generator would otherwise give (tests feed both
    packages the same draw). Over a mesh ``batch`` is this rank's share,
    ``draw`` the global pair, and the result this rank's term of the
    global mean (the module docstring)."""
    x0, context = batch["latents"], batch["context"]
    b, f = x0.shape[:2]
    dp, sp = (1, 1) if mesh is None else (mesh.dp.size, mesh.sp.size)
    shape = (b * dp, f * sp, *x0.shape[2:])
    if draw is None:
        dev = x0.device
        t = torch.randint(0, tables["num_timesteps"], (shape[0],), generator=generator, device=dev)
        noise = torch.randn(shape, generator=generator, device=dev, dtype=x0.dtype)
        draw = (t, noise)
    t, noise = draw
    if mesh is not None:
        t = mesh.dp.shard(t, 0)
        noise = mesh.sp.shard(mesh.dp.shard(noise, 0), 1)

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
    return ((pred - target) ** 2).sum() / torch.Size(shape).numel()


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


class TrainStep:
    """``step(state, batch, generator, draw=None) -> (state, loss)``:
    ``loss_and_grads`` then ``apply_gradients``. The state is updated in
    place and handed back; the loss is detached."""

    def __init__(self, term: Callable, mesh=None, ema_decay: float | None = None,
                 tp_summed: frozenset = frozenset()):
        self._term = term            # (params, batch, generator, draw) -> this rank's term
        self.mesh = mesh
        self.ema_decay = ema_decay
        self.tp_summed = tp_summed   # leaf names whose gradients also sum over tp

    def loss_and_grads(self, state: TrainState, batch, generator, draw=None):
        """(the loss, this rank's gradient of every state leaf in
        ``tree_items`` order): the global loss's gradient with respect to
        this rank's pieces, reduced over the mesh. A leaf the loss does not
        reach gets zeros (it still decays, as under optax), so every rank
        reduces the same list."""
        term = self._term(state.params, batch, generator, draw)
        items = tree_items(state.params)
        grads = torch.autograd.grad(term, [p for _, p in items], allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(p) for (_, p), g in zip(items, grads)]
        loss = term.detach()
        mesh = self.mesh
        if mesh is None:
            return loss, grads
        with audit.phase("gradient sum"):
            for axis in (mesh.sp, mesh.dp):
                if axis.size > 1:
                    grads = axis.all_reduce_buckets(grads)
                    loss = axis.all_reduce_buckets([loss])[0]
            if mesh.tp.size > 1 and self.tp_summed:
                picked = [i for i, (name, _) in enumerate(items) if name in self.tp_summed]
                for i, g in zip(picked, mesh.tp.all_reduce_buckets([grads[i] for i in picked])):
                    grads[i] = g
        return loss, grads

    def apply_gradients(self, state: TrainState, grads) -> TrainState:
        """One AdamW step of ``grads`` on the state's leaves, the step
        counter, and the EMA shadow when the step keeps one."""
        for p, g in zip(tree_leaves(state.params), grads):
            p.grad = g
        state.opt_state.step()
        state.opt_state.zero_grad(set_to_none=True)
        state.step += 1
        if self.ema_decay is not None and state.ema_params is not None:
            _ema_update(state.ema_params, state.params, self.ema_decay)
        return state

    def __call__(self, state: TrainState, batch, generator, draw=None):
        loss, grads = self.loss_and_grads(state, batch, generator, draw)
        return self.apply_gradients(state, grads), loss


def make_train_step(
    apply_fn: Callable,
    schedule: DiffusionSchedule,
    mesh=None,
    *,
    ema_decay: float | None = None,
    remat: bool = False,
    parameterization: str = "eps",
) -> TrainStep:
    """Returns ``train_step(state, batch, generator, draw=None) -> (state,
    loss)``; the state is updated in place and handed back.

    batch = {"latents": (B, F, H, W, C), "context": (B, L, D)} on the
    state's device (this rank's share over a ``mesh``, whose
    ``module_apply_fn`` ``apply_fn`` must be). ``ema_decay`` updates the
    EMA shadow carried in ``state.ema_params``. ``remat=True``
    rematerialises the UNet forward during the backward pass
    (``torch.utils.checkpoint``, non-reentrant: the recompute issues the
    forward's collectives again, in the same order on every rank): about
    one more forward of work for the activation memory."""
    tables = _device_tables(schedule)
    if remat:
        inner = apply_fn
        apply_fn = lambda params, x, t, context: checkpoint(
            inner, params, x, t, context, use_reentrant=False, preserve_rng_state=False)

    def term(params, batch, generator, draw):
        return diffusion_loss(apply_fn, params, tables(batch["latents"].device), batch,
                              generator, parameterization, draw, mesh)

    return TrainStep(term, mesh, ema_decay)


def init_train_state(params, optimizer: Optimizer, mesh=None, *, with_ema: bool = False,
                     layout: dict[str, bool] | None = None) -> TrainState:
    """A state on copies of ``params`` (the caller's tensors, e.g. a
    pipeline's weights, are never written to), each asking for a gradient;
    AdamW's moments are made at the first step; the EMA shadow is float32.
    Over a mesh the state holds this rank's pieces of the parameters that
    ``layout`` (``sharding.tp_layout`` of the UNet) names; other leaves,
    and a LoRA tree's factors, are whole. The state keeps the mesh and the
    layout, which ``io/train_state.py`` gathers and cuts it by."""
    tp = mesh.tp if mesh is not None else None
    layout = dict(layout or {}) if mesh is not None else {}
    params = {k: (tree_map(lambda p: p.detach().clone().requires_grad_(True), v)
                  if isinstance(v, dict) else
                  shard_tensor(v.detach(), k, layout, tp).clone().requires_grad_(True))
              for k, v in params.items()}
    ema = tree_map(lambda p: p.detach().float().clone(), params) if with_ema else None
    return TrainState(params=params, opt_state=optimizer(tree_leaves(params)), step=0,
                      ema_params=ema, mesh=mesh, layout=layout)


def make_lora_train_step(
    apply_fn: Callable,
    schedule: DiffusionSchedule,
    base_params,
    module_index,
    mesh=None,
    *,
    alpha: float = 1.0,
    parameterization: str = "eps",
    layout: dict[str, bool] | None = None,
) -> TrainStep:
    """LoRA fine-tuning step: ``state.params`` is the low-rank adapter tree
    (``pipeline/lora.py::init_lora``); the frozen base weights are merged
    functionally inside the loss, so only A and B receive gradients and the
    base tensors are never written to.

    Over a mesh the base is cut to this rank's tp pieces by ``layout``; A
    and B stay whole on every rank (the JAX package replicates the LoRA
    tree), each module's full delta is cut by the same rule and added to
    its piece. A factor whose delta feeds one tp slice gets only that
    slice's share of its gradient on each rank (B at a column-parallel
    site, A at a row-parallel one), so both factors of a split site are
    summed over tp."""
    from t2v_torch.pipeline.lora import apply_lora

    layout = layout or {}
    tp = mesh.tp if mesh is not None else None
    base = shard_params({k: v.detach() for k, v in base_params.items()}, layout, tp)
    local = None if tp is None else (lambda pname, d: shard_tensor(d, pname, layout, tp))
    tables = _device_tables(schedule)

    def term(lora, batch, generator, draw):
        merged = apply_lora(base, lora, module_index, alpha, local=local)
        return diffusion_loss(apply_fn, merged, tables(batch["latents"].device), batch,
                              generator, parameterization, draw, mesh)

    split = frozenset(f"{name}.{leaf}" for name, (pname, _) in module_index.items()
                      if pname in layout for leaf in ("lora_A", "lora_B"))
    return TrainStep(term, mesh, tp_summed=split)
