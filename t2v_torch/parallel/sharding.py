"""Tensor- and frame-parallel UNets: which weights split over tp, and which
modules talk over sp.

The port of the JAX package's ``parallel/sharding.py``, whose rules place
parameters for XLA's partitioner; here they are applied by hand and the
collectives are explicit (``parallel/mesh.py``).

tp (Megatron-style, over the attention heads and the GEGLU hidden width),
keyed by the reference state-dict names:

  column-parallel, output features split: ``to_q``, ``to_k``, ``to_v``,
      ``ff.net.0.proj`` (weight and bias);
  row-parallel, input features split: ``to_out.0`` and ``ff.net.2``
      (weight; the bias is added once, after the float32 all-reduce);
  everything else replicated: convolutions, norms, ``proj_in`` /
      ``proj_out``, the rel-pos tables.

Two layout choices differ from the JAX package's, and give the same
function: the packed GEGLU projection splits its value half and its gate
half separately (the JAX package splits the packed columns contiguously and
pays a redistribution for it), and an attention whose head count does not
divide by tp stays whole on every rank (where the JAX package splits the
columns and gathers the result, ``kernels/spmd.py``). A split attention
runs its kernels on heads / tp local heads.

sp (frames split over ranks): spatial layers are per frame and need
nothing. Each module that mixes frames gets the sp axis: ModelScope's
``TemporalTransformer`` and ``TemporalConvBlock`` and VideoCrafter's
``TemporalCrossAttention`` gather the frames at entry, run whole and keep
their own; VideoCrafter's GroupNorms (``FrameGroupNorm32``), whose
statistics span the frames, all-reduce their float32 sums.

The models declare their part: a module class that tp splits has a ``tp``
slot (None when whole), one that mixes frames an ``sp`` slot, and each
calls its collectives itself (``models/blocks.py``: ``row_parallel``,
``frames_gathered``, ``group_norm(sp=)``). This module only finds the
slots, fills them and slices the weights.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from t2v_torch.models import blocks as B
from t2v_torch.parallel.mesh import Axis

COLUMN_PARALLEL = ("to_q", "to_k", "to_v", "net.0.proj")
ROW_PARALLEL = ("to_out.0", "net.2")


def shard_dim(name: str, ndim: int) -> int | None:
    """The dim of the torch parameter ``name`` (of ``ndim`` dims) that tp
    splits, or None when it is replicated. Linear weights are (out, in):
    column-parallel splits dim 0 (and its bias), row-parallel dim 1."""
    owner, leaf = name.rsplit(".", 1)
    column = any(owner == p or owner.endswith("." + p) for p in COLUMN_PARALLEL)
    row = any(owner == p or owner.endswith("." + p) for p in ROW_PARALLEL)
    if ndim == 2 and leaf == "weight" and (column or row):
        return 0 if column else 1
    if ndim == 1 and leaf == "bias" and column:
        return 0
    return None


def _local(t: torch.Tensor, name: str, axis: Axis, halves: bool) -> torch.Tensor:
    dim = shard_dim(name, t.dim())
    if dim is None:
        return t
    if halves:  # the packed GEGLU projection: (value | gate) rows, each split
        return torch.cat([axis.shard(h, dim) for h in t.chunk(2, dim=dim)], dim=dim).contiguous()
    return axis.shard(t, dim).contiguous()


def _tp_modules(unet: nn.Module, tp: int):
    """The modules with a ``tp`` slot that tp splits: a GEGLU feed-forward
    whose width divides by tp, an attention whose heads do."""
    for name, mod in unet.named_modules():
        if hasattr(type(mod), "tp"):
            width = mod.net[2].in_features if isinstance(mod, B.GEGLUFeedForward) else mod.heads
            if width % tp == 0:
                yield name, mod


def _sp_modules(unet: nn.Module):
    """The modules with an ``sp`` slot: those that mix frames."""
    return [mod for mod in unet.modules() if hasattr(type(mod), "sp")]


@contextlib.contextmanager
def parallel_unet(unet: nn.Module, tp: Axis | None = None, sp: Axis | None = None):
    """Run ``unet`` tensor-parallel over ``tp`` and frame-parallel over
    ``sp`` (either may be None) inside the block: the split modules hold
    their rank's slices and local head counts, the frame-mixing ones their
    sp axis. The UNet then takes this rank's frames (F / sp of them) and
    returns its frames of the output, whole over tp. Everything is restored
    on exit. The weights are sliced in place: while the block is open the
    module (and a pipeline holding it) must serve no other request."""
    saved_params: list[tuple[nn.Module, str, nn.Parameter]] = []
    saved_attrs: list[tuple[nn.Module, str, object]] = []

    def set_attr(mod, attr, value):
        saved_attrs.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, value)

    try:
        if tp is not None and tp.size > 1:
            for prefix, mod in _tp_modules(unet, tp.size):
                ff = isinstance(mod, B.GEGLUFeedForward)
                for pname, p in list(mod.named_parameters()):
                    local = _local(p.data, f"{prefix}.{pname}", tp,
                                   halves=ff and pname.startswith("net.0.proj"))
                    if local is p.data:
                        continue
                    owner, leaf = (mod.get_submodule(pname.rsplit(".", 1)[0]),
                                   pname.rsplit(".", 1)[1])
                    saved_params.append((owner, leaf, p))
                    setattr(owner, leaf, nn.Parameter(local, requires_grad=False))
                if not ff:
                    set_attr(mod, "heads", mod.heads // tp.size)
                set_attr(mod, "tp", tp)
        if sp is not None and sp.size > 1:
            for mod in _sp_modules(unet):
                set_attr(mod, "sp", sp)
        yield unet
    finally:
        for mod, attr, value in reversed(saved_attrs):
            setattr(mod, attr, value)
        for owner, leaf, p in reversed(saved_params):
            setattr(owner, leaf, p)
