"""Training state on disk, for resume: parameters, AdamW moments and step
counts, the EMA shadow and the step counter in one ``train_state.safetensors``
beside a ``train_state.json`` side file (format version, step, and the run's
``mode``: LoRA rank, EMA on or off), so that an incompatible resume fails
with a clear message. The port's counterpart of the JAX package's
``io/orbax_io.py`` train-state functions; weights are stored as safetensors.
``save_weights`` writes the module weights a generation run loads
(``ModelScopePipeline.from_native``), ``load_weights`` reads them back.

A state trained over a mesh holds each rank's tp pieces and knows its mesh
and layout (``parallel/train.py``); on disk it is always the full tensors.
Every rank calls ``save_train_state``: the ranks of rank 0's tp group gather
the pieces and rank 0 writes. ``restore_train_state`` reads the full
tensors on every rank and cuts each to the rank's piece, AdamW's moments
and the EMA shadow too. ``full_tensors`` gathers a tree of the state (its
parameters or its EMA shadow) for a caller that writes weights. Its
gathers, the one place where full parameters are gathered by design, are
recorded in the save phase (``parallel/audit.py``); a restore issues no
collective.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import torch
import torch.distributed as dist

from t2v_torch.io.safetensors_io import load_torch, save_torch
from t2v_torch.parallel import audit
from t2v_torch.parallel.sharding import gather_tensor, shard_tensor
from t2v_torch.parallel.train import TrainState, tree_items

FORMAT_VERSION = 1


def full_tensors(state: TrainState, tree: dict) -> dict | None:
    """The full tensors of ``tree`` (``state.params`` or
    ``state.ema_params``, or a moment of each), flat by ``tree_items``
    name, on rank 0, None on the other ranks of the state's mesh. Every
    rank calls it: the ranks of rank 0's tp group join the gather of the
    split leaves."""
    mesh = state.mesh
    if mesh is None:
        return dict(tree_items(tree))
    if mesh.dp.index or mesh.sp.index:
        return None
    with audit.phase(audit.SAVE):
        full = {name: gather_tensor(t.detach(), name, state.layout, mesh.tp)
                for name, t in tree_items(tree)}
    return full if dist.get_rank() == 0 else None


def _moment(state: TrainState, key: str) -> dict:
    """{leaf name: AdamW's ``key`` of the leaf} of the leaves stepped."""
    opt = state.opt_state.state
    return {name: torch.as_tensor(opt[p][key]) for name, p in tree_items(state.params)
            if key in opt.get(p, {})}


def save_train_state(out_dir: str, state: TrainState, mode: dict | None = None) -> str:
    """Full training state (params + optimizer state + step + EMA), the
    full tensors of a state cut over a mesh. Every rank of the state's mesh
    calls it; rank 0 writes."""
    out_dir = os.path.abspath(out_dir)
    trees = {"params": full_tensors(state, state.params),
             "opt/exp_avg": full_tensors(state, _moment(state, "exp_avg")),
             "opt/exp_avg_sq": full_tensors(state, _moment(state, "exp_avg_sq")),
             "opt/step": _moment(state, "step"),  # a count, the same on every rank
             "ema": full_tensors(state, state.ema_params or {})}
    if trees["params"] is None:
        return out_dir
    tensors = {f"{prefix}/{name}": t for prefix, tree in trees.items() for name, t in tree.items()}
    os.makedirs(out_dir, exist_ok=True)
    save_torch(os.path.join(out_dir, "train_state.safetensors"), tensors)
    meta = {"format_version": FORMAT_VERSION, "step": int(state.step)}
    if mode:
        meta["mode"] = mode
    with open(os.path.join(out_dir, "train_state.json"), "w") as f:
        json.dump(meta, f)
    return out_dir


def train_state_mode(out_dir: str) -> dict:
    """The ``mode`` dict recorded at save time ({} when none was)."""
    with open(os.path.join(out_dir, "train_state.json")) as f:
        return json.load(f).get("mode", {})


def has_train_state(out_dir: str) -> bool:
    return os.path.exists(os.path.join(out_dir, "train_state.json"))


@torch.no_grad()
def restore_train_state(out_dir: str, template_state: TrainState) -> TrainState:
    """Restore into the structure, dtypes and devices of ``template_state``
    (made by ``init_train_state`` on the same configuration), in place.
    Each full tensor is cut to this rank's piece of the template's mesh."""
    out_dir = os.path.abspath(out_dir)
    tensors, _ = load_torch(os.path.join(out_dir, "train_state.safetensors"))
    with open(os.path.join(out_dir, "train_state.json")) as f:
        meta = json.load(f)
    if meta["format_version"] > FORMAT_VERSION:
        raise ValueError(f"train state format {meta['format_version']} is newer than this "
                         f"build ({FORMAT_VERSION})")
    mesh, layout = template_state.mesh, template_state.layout
    tp = mesh.tp if mesh is not None else None

    def piece(key: str, name: str, like: torch.Tensor) -> torch.Tensor:
        src = tensors.get(key)
        if src is not None:
            src = shard_tensor(src, name, layout, tp)
        if src is None or src.shape != like.shape:
            raise KeyError(f"{out_dir}: no {key} of shape {tuple(like.shape)}")
        return src.to(like.device, like.dtype, copy=True)

    for prefix, tree in (("params", template_state.params), ("ema", template_state.ema_params)):
        for name, p in tree_items(tree or {}):
            p.copy_(piece(f"{prefix}/{name}", name, p))
    opt = template_state.opt_state
    for name, p in tree_items(template_state.params):
        if f"opt/exp_avg/{name}" not in tensors:
            continue  # saved before its first step
        opt.state[p] = {
            "step": tensors[f"opt/step/{name}"].to(torch.float32),
            "exp_avg": piece(f"opt/exp_avg/{name}", name, p),
            "exp_avg_sq": piece(f"opt/exp_avg_sq/{name}", name, p),
        }
    template_state.step = int(meta["step"])
    return template_state


def latest_train_state(root: str) -> str | None:
    """Newest ``step_N`` / ``lora_state_N`` dir under ``root`` carrying a
    train state (LoRA runs save states under the distinct ``lora_state_``
    prefix so that they are never mistaken for full checkpoints)."""
    if not os.path.isdir(root):
        return None
    best, best_step = None, -1
    for name in os.listdir(root):
        p = os.path.join(root, name)
        if (name.startswith("step_") or name.startswith("lora_state_")) and has_train_state(p):
            try:
                s = int(name.rsplit("_", 1)[1])
            except ValueError:
                continue
            if s > best_step:
                best, best_step = p, s
    return best


WEIGHTS_META = "t2v_torch.json"
_COMPONENTS = ("unet", "vae", "clip")


def save_weights(out_dir: str, *, unet_params, vae, clip, unet_cfg, vae_cfg, clip_cfg,
                 model_family: str, tokenizer_vocab: str | None = None) -> str:
    """The weights of a trained model under their reference state-dict
    names: ``unet.safetensors`` (the tree it is given, e.g. the EMA shadow),
    ``vae.safetensors``, ``clip.safetensors`` and a ``t2v_torch.json`` with
    the three configs and the model family. ``tokenizer_vocab`` (the BPE
    file the text tower's tokenizer was read from) is copied beside them
    under the published vocab name, so the directory loads on its own."""
    out_dir = os.path.abspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    save_torch(os.path.join(out_dir, "unet.safetensors"), dict(tree_items(unet_params)))
    save_torch(os.path.join(out_dir, "vae.safetensors"), vae.state_dict())
    save_torch(os.path.join(out_dir, "clip.safetensors"), clip.state_dict())
    if tokenizer_vocab and os.path.exists(tokenizer_vocab):
        # under the name the loaders look for, whatever the source's name
        name = "bpe_simple_vocab_16e6.txt" + (".gz" if tokenizer_vocab.endswith(".gz") else "")
        target = os.path.join(out_dir, name)
        if os.path.abspath(tokenizer_vocab) != target:  # saving over its own dir
            shutil.copy(tokenizer_vocab, target)
    meta = {
        "format_version": FORMAT_VERSION, "model_family": model_family,
        "unet_cfg": dataclasses.asdict(unet_cfg), "vae_cfg": dataclasses.asdict(vae_cfg),
        "clip_cfg": dataclasses.asdict(clip_cfg),
    }
    with open(os.path.join(out_dir, WEIGHTS_META), "w") as f:
        json.dump(meta, f)
    return out_dir


def is_native_checkpoint(model_dir: str) -> bool:
    """True for a directory that ``save_weights`` wrote."""
    return os.path.exists(os.path.join(model_dir, WEIGHTS_META))


def load_weights(model_dir: str, only: tuple[str, ...] = _COMPONENTS) -> tuple[dict, dict]:
    """(meta, {component: state dict of CPU tensors}) of a ``save_weights``
    directory, for the components named in ``only``."""
    with open(os.path.join(model_dir, WEIGHTS_META)) as f:
        meta = json.load(f)
    if meta["format_version"] > FORMAT_VERSION:
        raise ValueError(f"weights format {meta['format_version']} is newer than this build "
                         f"({FORMAT_VERSION})")
    sds = {name: load_torch(os.path.join(model_dir, f"{name}.safetensors"))[0] for name in only}
    return meta, sds
