"""Training state on disk, for resume: parameters, AdamW moments and step
counts, the EMA shadow and the step counter in one ``train_state.safetensors``
beside a ``train_state.json`` side file (format version, step, and the run's
``mode``: LoRA rank, EMA on or off), so that an incompatible resume fails
with a clear message. The port's counterpart of the JAX package's
``io/orbax_io.py`` train-state functions; weights are stored as safetensors.
``save_weights`` writes the module weights a generation run loads
(``ModelScopePipeline.from_native``), ``load_weights`` reads them back.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import torch

from t2v_torch.io.safetensors_io import load_torch, save_torch
from t2v_torch.parallel.train import TrainState, tree_items

FORMAT_VERSION = 1
_MOMENTS = ("exp_avg", "exp_avg_sq", "step")


def save_train_state(out_dir: str, state: TrainState, mode: dict | None = None) -> str:
    """Full training state (params + optimizer state + step + EMA)."""
    out_dir = os.path.abspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    tensors = {}
    for name, p in tree_items(state.params):
        tensors[f"params/{name}"] = p
        moments = state.opt_state.state.get(p, {})
        for key in _MOMENTS:
            if key in moments:
                tensors[f"opt/{key}/{name}"] = torch.as_tensor(moments[key])
    if state.ema_params is not None:
        for name, e in tree_items(state.ema_params):
            tensors[f"ema/{name}"] = e
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
    (made by ``init_train_state`` on the same configuration), in place."""
    out_dir = os.path.abspath(out_dir)
    tensors, _ = load_torch(os.path.join(out_dir, "train_state.safetensors"))
    with open(os.path.join(out_dir, "train_state.json")) as f:
        meta = json.load(f)
    if meta["format_version"] > FORMAT_VERSION:
        raise ValueError(f"train state format {meta['format_version']} is newer than this "
                         f"build ({FORMAT_VERSION})")

    def fill(prefix: str, tree) -> None:
        for name, p in tree_items(tree):
            src = tensors.get(f"{prefix}/{name}")
            if src is None or src.shape != p.shape:
                raise KeyError(f"{out_dir}: no {prefix}/{name} of shape {tuple(p.shape)}")
            p.copy_(src.to(p.device, p.dtype))

    fill("params", template_state.params)
    if template_state.ema_params is not None:
        fill("ema", template_state.ema_params)
    opt = template_state.opt_state
    for name, p in tree_items(template_state.params):
        if f"opt/exp_avg/{name}" not in tensors:
            continue  # saved before its first step
        opt.state[p] = {
            "step": tensors[f"opt/step/{name}"].to(torch.float32),
            "exp_avg": tensors[f"opt/exp_avg/{name}"].to(p.device, p.dtype),
            "exp_avg_sq": tensors[f"opt/exp_avg_sq/{name}"].to(p.device, p.dtype),
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
