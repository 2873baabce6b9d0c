"""LoRA for the port's ModelScope UNet: low-rank adapters as a separate
trainable tree, merged functionally into frozen base weights, and the two
file formats of the reference.

The port of the training half of the JAX package's ``pipeline/lora.py``. A
LoRA tree is ``{module_name: {"lora_A": (in, r), "lora_B": (r, out)}}`` of
float32 tensors, keyed by the reference torch module path, in the JAX tree's
layout: A and B multiply as ``A @ B`` into an (in, out) delta, which is the
transpose of an ``nn.Linear`` weight (out, in), so the merge adds
``(A @ B).T``. The port's modules sit at the reference's module paths, so
the module index maps a module name to its parameter's name in
``unet.state_dict()`` (``<name>.weight``) and its layout kind.

File formats:
  * **stable-lora** (ModelScope): ``<name>.lora_A`` (r, in) / ``<name>.lora_B``
    (out, r); merge is ``W += (B @ A) * alpha`` with the Conv3d temporal
    mean-collapse and optional bias deltas;
  * **cloneofsimo / LVDM** (VideoCrafter): ``<name>.lora_down.weight``
    (r, in) / ``<name>.lora_up.weight`` (out, r); merge is
    ``W += (up @ down) * scale`` (``merge_lvdm_lora``).

``discover_loras`` finds the stable-lora files of a directory tree by their
header's metadata tag.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from t2v_torch.core.config import CLIPTextConfig, ModelScopeUNetConfig
from t2v_torch.io.safetensors_io import read_safetensors_metadata, save_safetensors
from t2v_torch.models.modelscope_unet import BlockDesc, build_topology

METADATA_TAG = "stable_lora_text_to_video"
ModuleIndex = Mapping[str, tuple[str, str]]


def unet_module_index(cfg: ModelScopeUNetConfig) -> dict[str, tuple[str, str]]:
    """Every weight-bearing module path of UNetSD -> (its weight's name in
    the state dict, layout kind "linear" | "conv2d" | "conv3d" | "conv1d"),
    in the JAX package's ``torch_module_index`` order."""
    idx: dict[str, tuple[str, str]] = {}

    def add(name: str, kind: str) -> None:
        idx[name] = (f"{name}.weight", kind)

    def add_btb(tp: str) -> None:
        for attn in ("attn1", "attn2"):
            for proj in ("to_q", "to_k", "to_v"):
                add(f"{tp}.{attn}.{proj}", "linear")
            add(f"{tp}.{attn}.to_out.0", "linear")
        add(f"{tp}.ff.net.0.proj", "linear")
        add(f"{tp}.ff.net.2", "linear")

    def add_block(d: BlockDesc) -> None:
        tp = d.torch_path
        if d.kind == "conv_in":
            add(tp, "conv2d")
        elif d.kind == "res":
            add(f"{tp}.in_layers.2", "conv2d")
            add(f"{tp}.emb_layers.1", "linear")
            add(f"{tp}.out_layers.3", "conv2d")
            if d.in_ch != d.out_ch:
                add(f"{tp}.skip_connection", "conv2d")
            for i in range(1, 5):
                add(f"{tp}.temopral_conv.conv{i}.{2 if i == 1 else 3}", "conv3d")
        elif d.kind in ("spatial", "temporal"):
            proj_kind = "linear" if d.kind == "spatial" else "conv1d"
            add(f"{tp}.proj_in", proj_kind)
            add(f"{tp}.proj_out", proj_kind)
            add_btb(f"{tp}.transformer_blocks.0")
        elif d.kind == "downsample":
            add(f"{tp}.op", "conv2d")
        elif d.kind == "upsample":
            add(f"{tp}.conv", "conv2d")

    add("time_embed.0", "linear")
    add("time_embed.2", "linear")
    add("out.2", "conv2d")
    topo = build_topology(cfg)
    for entry in (*topo.encoder, topo.middle, *topo.decoder):
        for d in entry:
            add_block(d)
    return idx


def text_module_index(cfg: CLIPTextConfig) -> dict[str, tuple[str, str]]:
    """Stable-lora module index of the OpenCLIP text tower. The reference
    merges CLIP LoRAs into its tower's ``transformer`` sub-module, so file
    keys are named relative to it (``resblocks.N.attn.out_proj``) and reach
    only its ``nn.Linear`` leaves (the fused attention ``in_proj`` is no
    Linear module); each maps to its weight's name in the tower's state
    dict."""
    idx: dict[str, tuple[str, str]] = {}
    n_layers = cfg.layers - (1 if cfg.layer == "penultimate" else 0)
    for i in range(n_layers):
        for leaf in ("attn.out_proj", "mlp.c_fc", "mlp.c_proj"):
            idx[f"resblocks.{i}.{leaf}"] = (f"transformer.resblocks.{i}.{leaf}.weight", "linear")
    return idx


def init_lora(
    params: Mapping[str, torch.Tensor],
    module_index: ModuleIndex,
    rank: int,
    generator: torch.Generator,
) -> dict[str, dict[str, torch.Tensor]]:
    """A LoRA tree over every *linear* weight of ``params`` (a state dict)
    that the index names: A ~ N(0, 1) / r, B = 0, so the merged delta starts
    at zero. float32 on the weights' device; the leaves ask for gradients."""
    lora: dict[str, dict[str, torch.Tensor]] = {}
    for name, (pname, kind) in module_index.items():
        if kind != "linear" or pname not in params:
            continue
        w = params[pname]
        if w.dim() != 2:
            continue
        d_out, d_in = w.shape
        a = torch.randn((d_in, rank), generator=generator, device=generator.device,
                        dtype=torch.float32).to(w.device) / rank
        lora[name] = {
            "lora_A": a.requires_grad_(),
            "lora_B": torch.zeros((rank, d_out), device=w.device, dtype=torch.float32,
                                  requires_grad=True),
        }
    return lora


def lora_delta(ab: Mapping[str, torch.Tensor], alpha: float = 1.0) -> torch.Tensor:
    """The (in, out) delta of one module: (A [* diag]) @ B * scale? * alpha."""
    a = ab["lora_A"]
    if "diag" in ab:
        a = a * ab["diag"][None, :]
    return (a @ ab["lora_B"]) * (alpha * ab.get("scale", 1.0))


def apply_lora(
    params: Mapping[str, torch.Tensor],
    lora: Mapping[str, Mapping[str, torch.Tensor]],
    module_index: ModuleIndex,
    alpha: float = 1.0,
    local=None,
) -> dict[str, torch.Tensor]:
    """Functionally merge a (trainable) LoRA tree into a state dict: a new
    dict whose adapted weights are ``W + delta.T`` (cast to W's dtype) and
    whose other entries are the base tensors themselves. The base tensors
    are not written to; gradients reach only A and B (hand it detached base
    weights, as ``make_lora_train_step`` does). Optional per-module
    ``scale`` / ``diag`` entries act as the reference wrapper's runtime
    scale and rank selector. ``local(weight name, delta.T)``, when given,
    cuts the full (out, in) delta to the piece of the weight that
    ``params`` holds (a tp rank's piece)."""
    new = dict(params)
    for name, ab in lora.items():
        pname, _ = module_index[name]
        w = params[pname]
        delta = lora_delta(ab, alpha).T
        if local is not None:
            delta = local(pname, delta)
        new[pname] = w + delta.to(w.dtype)
    return new


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


def lora_to_stable_sd(lora: Mapping[str, Mapping]) -> dict[str, np.ndarray]:
    """LoRA tree -> stable-lora state dict: A (in, r) -> lora_A (r, in);
    B (r, out) -> lora_B (out, r)."""
    sd = {}
    for name, ab in lora.items():
        sd[f"{name}.lora_A"] = _np(ab["lora_A"]).T.copy()
        sd[f"{name}.lora_B"] = _np(ab["lora_B"]).T.copy()
    return sd


def save_stable_lora(path: str, lora: Mapping[str, Mapping],
                     metadata: Mapping[str, str] | None = None) -> str:
    """Write a reference-compatible stable-lora .safetensors."""
    meta = {METADATA_TAG: "true"}
    if metadata:
        meta.update({k: str(v) for k, v in metadata.items()})
    return save_safetensors(path, lora_to_stable_sd(lora), meta)


def lora_to_lvdm_sd(lora: Mapping[str, Mapping]) -> dict[str, np.ndarray]:
    """LoRA tree -> cloneofsimo / LVDM layout: ``<name>.lora_down.weight``
    (r, in) and ``<name>.lora_up.weight`` (out, r)."""
    sd = {}
    for name, ab in lora.items():
        sd[f"{name}.lora_down.weight"] = _np(ab["lora_A"]).T.copy()
        sd[f"{name}.lora_up.weight"] = _np(ab["lora_B"]).T.copy()
    return sd


def save_lvdm_lora(path: str, lora: Mapping[str, Mapping],
                   metadata: Mapping[str, str] | None = None) -> str:
    """Write an extracted LoRA in the LVDM (cloneofsimo) format."""
    meta = {k: str(v) for k, v in (metadata or {}).items()}
    return save_safetensors(path, lora_to_lvdm_sd(lora), meta or None)


def _delta_to_weight(delta: torch.Tensor, kind: str, shape: torch.Size) -> torch.Tensor:
    """A torch-layout (out, in...) LoRA delta shaped as the target weight."""
    if kind in ("linear", "conv1d", "conv2d"):
        return delta.reshape(shape)
    if kind == "conv3d":
        # temporal (kt, 1, 1) conv: the reference views the 2D-trained delta
        # as (out, in, k, k, 1) and mean-collapses the second spatial axis
        cout, cin, kt = shape[0], shape[1], shape[2]
        return delta.reshape(cout, cin, kt, kt, 1).mean(dim=3, keepdim=True)
    raise ValueError(kind)


def merge_stable_lora(
    params: Mapping[str, torch.Tensor],
    lora_sd: Mapping[str, np.ndarray],
    alpha: float,
    module_index: ModuleIndex,
    *,
    undo: bool = False,
    merge_bias: bool = True,
) -> tuple[dict[str, torch.Tensor], list[str]]:
    """Merge a stable-lora state dict (numpy, as read from the file) into a
    state dict: ``W += (B @ A) * alpha`` in float32, cast back to W's dtype.
    Returns (new state dict, skipped module names); names absent from the
    index or the state dict are skipped and reported. ``undo`` merges with
    ``-alpha``."""
    sign = -1.0 if undo else 1.0
    new = dict(params)
    skipped: list[str] = []
    for key in lora_sd:
        if not key.endswith(".lora_A"):
            continue
        name = key[: -len(".lora_A")]
        if name not in module_index or module_index[name][0] not in new:
            skipped.append(name)
            continue
        pname, kind = module_index[name]
        w = new[pname]
        a = torch.from_numpy(np.array(lora_sd[key], np.float32))
        b = torch.from_numpy(np.array(lora_sd[f"{name}.lora_B"], np.float32))
        while a.dim() > 2:
            a = a.squeeze(-1)
        while b.dim() > 2:
            b = b.squeeze(-1)
        delta = _delta_to_weight((b @ a).to(w.device), kind, w.shape)
        new[pname] = (w.float() + sign * alpha * delta).to(w.dtype)
        bias_name = pname.removesuffix("weight") + "bias"
        if merge_bias and f"{name}.bias" in lora_sd and bias_name in new:
            bias = new[bias_name]
            db = torch.from_numpy(np.array(lora_sd[f"{name}.bias"], np.float32)).to(bias.device)
            new[bias_name] = (bias.float() + sign * alpha * db).to(bias.dtype)
    return new, skipped


def _f32(x) -> torch.Tensor:
    """A file's factor (numpy, or a torch tensor of any float dtype) as a
    float32 CPU tensor."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(x, np.float32))


def merge_lvdm_lora(
    params: Mapping[str, torch.Tensor],
    lora_sd: Mapping,
    module_index: ModuleIndex,
    scale: float = 1.0,
) -> tuple[dict[str, torch.Tensor], list[str]]:
    """Merge a cloneofsimo / LVDM LoRA state dict (numpy or torch factors)
    into a state dict: ``W += (up @ down) * scale`` in float32, cast back to
    W's dtype; conv-shaped factors squeeze their trailing singleton dims.
    Returns (new state dict, skipped module names): a name with no
    ``lora_down`` partner, or absent from the index or the state dict."""
    new = dict(params)
    skipped: list[str] = []
    up_sfx, down_sfx = ".lora_up.weight", ".lora_down.weight"
    downs = {k[: -len(down_sfx)]: v for k, v in lora_sd.items() if k.endswith(down_sfx)}
    for key, up in lora_sd.items():
        if not key.endswith(up_sfx):
            continue
        name = key[: -len(up_sfx)]
        if name not in downs or name not in module_index or module_index[name][0] not in new:
            skipped.append(name)
            continue
        pname, kind = module_index[name]
        w = new[pname]
        u, d = _f32(up), _f32(downs[name])
        while u.dim() > 2:
            u = u.squeeze(-1)
        while d.dim() > 2:
            d = d.squeeze(-1)
        delta = _delta_to_weight(((u @ d) * scale).to(w.device), kind, w.shape)
        new[pname] = (w.float() + delta).to(w.dtype)
    return new, skipped


def discover_loras(lora_dir: str) -> list[dict]:
    """Every stable-lora ``.safetensors`` file under ``lora_dir`` (sorted,
    recursive), known by the metadata tag in its header; only the header is
    read. Returns each file's metadata with its ``path`` and ``lora_name``
    (the file name without extension) added; a file whose header cannot be
    read is passed over."""
    import glob
    import os

    found = []
    for path in sorted(glob.glob(os.path.join(lora_dir, "**", "*.safetensors"), recursive=True)):
        try:
            metadata = read_safetensors_metadata(path)
        except (OSError, ValueError):
            continue
        if metadata is not None and METADATA_TAG in metadata:
            metadata = dict(metadata, path=path,
                            lora_name=os.path.splitext(os.path.basename(path))[0])
            found.append(metadata)
    return found
