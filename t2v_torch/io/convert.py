"""Checkpoints and JAX parameter trees -> the port's modules.

The port's modules carry the reference torch state-dict names, so a
published checkpoint (``text2video_pytorch_model.pth``,
``VQGAN_autoencoder.pth``, ``open_clip_pytorch_model.bin``) loads with
``load_torch_checkpoint`` and ``load_state``, with no layout conversion; the
VAE file's ``state_dict`` / ``first_stage_model.`` wrapping is undone by
``strip_first_stage_prefix``.

The rest of the module is the inverse of the JAX package's converters (``io/convert.py::convert_unet``,
``convert_vae``, ``io/convert_vc.py::convert_vc_unet`` and
``text/clip.py::convert_open_clip_text`` / ``convert_hf_clip_text``): each takes
the JAX package's parameter tree as numpy arrays (with or without the
top-level ``"params"`` key) and returns a dict of numpy arrays under the
reference torch state-dict keys and layouts, which the port's modules load
with ``load_state_dict``. Converting back with the JAX package's own
converter gives the original tree exactly.

Layout rules (JAX -> torch):
  Dense kernel (in, out)          -> Linear (out, in)            [transpose]
  Conv kernel (kh, kw, in, out)   -> Conv2d (out, in, kh, kw)    [(3, 2, 0, 1)]
  Conv kernel (kt, kh, kw, in, out) -> Conv3d (out, in, kt, kh, kw) [(4, 3, 0, 1, 2)]
  Dense kernel (in, out)          -> Conv1d k=1 (out, in, 1)     [T + axis]
  Dense kernel (in, out)          -> Conv3d k=1 (out, in, 1, 1, 1) [T + axes]
  Norm scale / bias               -> weight / bias
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from t2v_torch.core.config import (
    CLIPTextConfig,
    ModelScopeUNetConfig,
    VAEConfig,
    VideoCrafterUNetConfig,
)
from t2v_torch.models.modelscope_unet import BlockDesc, build_topology
from t2v_torch.models.videocrafter_unet import VCBlockDesc, build_vc_topology

Tree = Mapping[str, Any]


def _unwrap(tree: Tree) -> Tree:
    return tree["params"] if "params" in tree else tree


def _a(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x))


def _linear(sd: dict, p: str, t: Tree) -> None:
    sd[f"{p}.weight"] = _a(np.asarray(t["kernel"]).T)
    if "bias" in t:
        sd[f"{p}.bias"] = _a(t["bias"])


def _conv2d(sd: dict, p: str, t: Tree) -> None:
    sd[f"{p}.weight"] = _a(np.asarray(t["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{p}.bias"] = _a(t["bias"])


def _conv3d(sd: dict, p: str, t: Tree) -> None:
    sd[f"{p}.weight"] = _a(np.asarray(t["kernel"]).transpose(4, 3, 0, 1, 2))
    sd[f"{p}.bias"] = _a(t["bias"])


def _conv1d_from_dense(sd: dict, p: str, t: Tree) -> None:
    sd[f"{p}.weight"] = _a(np.asarray(t["kernel"]).T[:, :, None])
    sd[f"{p}.bias"] = _a(t["bias"])


def _norm(sd: dict, p: str, t: Tree) -> None:
    sd[f"{p}.weight"] = _a(t["scale"])
    sd[f"{p}.bias"] = _a(t["bias"])


def _gn32(sd: dict, p: str, t: Tree) -> None:
    _norm(sd, p, t["GroupNorm_0"])


def _basic_transformer_block(sd: dict, p: str, t: Tree) -> None:
    for attn in ("attn1", "attn2"):
        for proj in ("to_q", "to_k", "to_v"):
            _linear(sd, f"{p}.{attn}.{proj}", t[attn][proj])
        _linear(sd, f"{p}.{attn}.to_out.0", t[attn]["to_out"])
    for n in ("norm1", "norm2", "norm3"):
        _norm(sd, f"{p}.{n}", t[n])
    _linear(sd, f"{p}.ff.net.0.proj", t["ff"]["geglu"])
    _linear(sd, f"{p}.ff.net.2", t["ff"]["out"])


def _block(sd: dict, d: BlockDesc, t: Tree) -> None:
    p = d.torch_path
    if d.kind == "conv_in":
        _conv2d(sd, p, t)
    elif d.kind == "res":
        _gn32(sd, f"{p}.in_layers.0", t["in_norm"])
        _conv2d(sd, f"{p}.in_layers.2", t["in_conv"])
        _linear(sd, f"{p}.emb_layers.1", t["emb"])
        _gn32(sd, f"{p}.out_layers.0", t["out_norm"])
        _conv2d(sd, f"{p}.out_layers.3", t["out_conv"])
        if d.in_ch != d.out_ch:
            _conv2d(sd, f"{p}.skip_connection", t["skip"])
        tc = t["temporal_conv"]
        for i in range(1, 5):
            ci = 2 if i == 1 else 3
            _gn32(sd, f"{p}.temopral_conv.conv{i}.0", tc[f"norm{i}"])
            _conv3d(sd, f"{p}.temopral_conv.conv{i}.{ci}", tc[f"conv{i}"])
    elif d.kind in ("spatial", "temporal"):
        _gn32(sd, f"{p}.norm", t["norm"])
        proj = _linear if d.kind == "spatial" else _conv1d_from_dense
        proj(sd, f"{p}.proj_in", t["proj_in"])
        proj(sd, f"{p}.proj_out", t["proj_out"])
        _basic_transformer_block(sd, f"{p}.transformer_blocks.0", t["block_0"])
    elif d.kind == "downsample":
        _conv2d(sd, f"{p}.op", t["op"])
    elif d.kind == "upsample":
        _conv2d(sd, f"{p}.conv", t["conv"])
    else:
        raise ValueError(d.kind)


def from_jax_unet(params: Tree, cfg: ModelScopeUNetConfig) -> dict[str, np.ndarray]:
    """JAX ``UNetSD`` parameters -> reference UNet state dict."""
    t = _unwrap(params)
    sd: dict[str, np.ndarray] = {}
    _linear(sd, "time_embed.0", t["time_embed_0"])
    _linear(sd, "time_embed.2", t["time_embed_2"])
    _gn32(sd, "out.0", t["head_norm"])
    _conv2d(sd, "out.2", t["head_conv"])
    topo = build_topology(cfg)
    for entry in (*topo.encoder, topo.middle, *topo.decoder):
        for d in entry:
            _block(sd, d, t[d.flax_name])
    return sd


def _conv3d_k1_from_dense(sd: dict, p: str, t: Tree) -> None:
    sd[f"{p}.weight"] = _a(np.asarray(t["kernel"]).T[:, :, None, None, None])
    sd[f"{p}.bias"] = _a(t["bias"])


def _vc_attn(sd: dict, p: str, t: Tree) -> None:
    for proj in ("to_q", "to_k", "to_v"):
        _linear(sd, f"{p}.{proj}", t[proj])
    _linear(sd, f"{p}.to_out.0", t["to_out"])
    for table in ("relative_position_k", "relative_position_v"):
        if table in t:
            sd[f"{p}.{table}.embeddings_table"] = _a(t[table]["embeddings_table"])


def _vc_block(sd: dict, d: VCBlockDesc, t: Tree, depth: int) -> None:
    p = d.torch_path
    if d.kind == "conv_in":
        _conv3d(sd, p, t["conv"])
    elif d.kind == "res":
        _gn32(sd, f"{p}.in_layers.0", t["in_norm"])
        _conv3d(sd, f"{p}.in_layers.2", t["in_conv"]["conv"])
        _linear(sd, f"{p}.emb_layers.1", t["emb"])
        _gn32(sd, f"{p}.out_layers.0", t["out_norm"])
        _conv3d(sd, f"{p}.out_layers.3", t["out_conv"]["conv"])
        if d.in_ch != d.out_ch:
            _conv3d(sd, f"{p}.skip_connection", t["skip"])
    elif d.kind == "st":
        _gn32(sd, f"{p}.norm", t["norm"])
        _conv3d_k1_from_dense(sd, f"{p}.proj_in", t["proj_in"])
        _conv3d_k1_from_dense(sd, f"{p}.proj_out", t["proj_out"])
        for i in range(depth):
            bp, bt = f"{p}.transformer_blocks.{i}", t[f"block_{i}"]
            for attn in ("attn1", "attn2", "attn1_tmp", "attn2_tmp"):
                _vc_attn(sd, f"{bp}.{attn}", bt[attn])
            for n in ("norm1", "norm2", "norm3", "norm4", "norm5"):
                _norm(sd, f"{bp}.{n}", bt[n])
            _linear(sd, f"{bp}.ff.net.0.proj", bt["ff"]["geglu"])
            _linear(sd, f"{bp}.ff.net.2", bt["ff"]["out"])
    elif d.kind == "downsample":
        _conv3d(sd, f"{p}.op", t["conv"])
    elif d.kind == "upsample":
        _conv3d(sd, f"{p}.conv", t["conv_mod"]["conv"])
    else:
        raise ValueError(d.kind)


def from_jax_vc_unet(params: Tree, cfg: VideoCrafterUNetConfig) -> dict[str, np.ndarray]:
    """JAX ``VideoCrafterUNet`` parameters -> the Lightning checkpoint's
    ``model.diffusion_model.*`` state dict (prefix stripped)."""
    t = _unwrap(params)
    sd: dict[str, np.ndarray] = {}
    _linear(sd, "time_embed.0", t["time_embed_0"])
    _linear(sd, "time_embed.2", t["time_embed_2"])
    _gn32(sd, "out.0", t["head_norm"])
    _conv3d(sd, "out.2", t["head_conv"]["conv"])
    topo = build_vc_topology(cfg)
    for entry in (*topo.encoder, topo.middle, *topo.decoder):
        for d in entry:
            _vc_block(sd, d, t[d.flax_name], cfg.transformer_depth)
    return sd


def _vae_resnet(sd: dict, p: str, t: Tree) -> None:
    _norm(sd, f"{p}.norm1", t["norm1"])
    _conv2d(sd, f"{p}.conv1", t["conv1"])
    _norm(sd, f"{p}.norm2", t["norm2"])
    _conv2d(sd, f"{p}.conv2", t["conv2"])
    if "nin_shortcut" in t:
        _conv2d(sd, f"{p}.nin_shortcut", t["nin_shortcut"])


def _vae_attn(sd: dict, p: str, t: Tree) -> None:
    _norm(sd, f"{p}.norm", t["norm"])
    for n in ("q", "k", "v", "proj_out"):
        _conv2d(sd, f"{p}.{n}", t[n])


def from_jax_vae(params: Tree, cfg: VAEConfig) -> dict[str, np.ndarray]:
    """JAX ``AutoencoderKL`` parameters -> reference VAE state dict:
    encoder, ``quant_conv``, decoder and ``post_quant_conv``."""
    t = _unwrap(params)
    sd: dict[str, np.ndarray] = {}
    nm = len(cfg.ch_mult)
    for part, levels, n_blocks, kind in (
        ("encoder", "down", cfg.num_res_blocks, "downsample"),
        ("decoder", "up", cfg.num_res_blocks + 1, "upsample"),
    ):
        tp = t[part]
        _conv2d(sd, f"{part}.conv_in", tp["conv_in"])
        _vae_resnet(sd, f"{part}.mid.block_1", tp["mid_block_1"])
        _vae_attn(sd, f"{part}.mid.attn_1", tp["mid_attn_1"])
        _vae_resnet(sd, f"{part}.mid.block_2", tp["mid_block_2"])
        _norm(sd, f"{part}.norm_out", tp["norm_out"])
        _conv2d(sd, f"{part}.conv_out", tp["conv_out"])
        for i in range(nm):
            for j in range(n_blocks):
                _vae_resnet(sd, f"{part}.{levels}.{i}.block.{j}", tp[f"{levels}_{i}_block_{j}"])
                if f"{levels}_{i}_attn_{j}" in tp:
                    _vae_attn(sd, f"{part}.{levels}.{i}.attn.{j}", tp[f"{levels}_{i}_attn_{j}"])
            if f"{levels}_{i}_{kind}" in tp:
                _conv2d(sd, f"{part}.{levels}.{i}.{kind}.conv", tp[f"{levels}_{i}_{kind}"]["conv"])
    _conv2d(sd, "quant_conv", t["quant_conv"])
    _conv2d(sd, "post_quant_conv", t["post_quant_conv"])
    return sd


def _from_jax_clip_hf(t: Tree, n_layers: int) -> dict[str, np.ndarray]:
    pre = "text_model."
    sd: dict[str, np.ndarray] = {
        f"{pre}embeddings.token_embedding.weight": _a(t["token_embedding"]["embedding"]),
        f"{pre}embeddings.position_embedding.weight": _a(t["positional_embedding"]),
    }
    _norm(sd, f"{pre}final_layer_norm", t["ln_final"])
    for i in range(n_layers):
        tp, b = f"{pre}encoder.layers.{i}", t[f"resblock_{i}"]
        _norm(sd, f"{tp}.layer_norm1", b["ln_1"])
        _norm(sd, f"{tp}.layer_norm2", b["ln_2"])
        w = np.asarray(b["in_proj"]["kernel"]).T
        bias = np.asarray(b["in_proj"]["bias"])
        for j, n in enumerate(("q", "k", "v")):
            width = w.shape[1]
            sd[f"{tp}.self_attn.{n}_proj.weight"] = _a(w[j * width : (j + 1) * width])
            sd[f"{tp}.self_attn.{n}_proj.bias"] = _a(bias[j * width : (j + 1) * width])
        _linear(sd, f"{tp}.self_attn.out_proj", b["out_proj"])
        _linear(sd, f"{tp}.mlp.fc1", b["c_fc"])
        _linear(sd, f"{tp}.mlp.fc2", b["c_proj"])
    return sd


def from_jax_clip(params: Tree, cfg: CLIPTextConfig, layout: str = "open_clip") -> dict[str, np.ndarray]:
    """JAX ``CLIPTextTransformer`` parameters -> a text-tower state dict in
    the ``open_clip`` layout (``CLIPTextTransformer``) or the Hugging Face
    ``hf`` layout of the CLIP-L tower (``HFCLIPTextModel``)."""
    t = _unwrap(params)
    if layout == "hf":
        return _from_jax_clip_hf(t, cfg.layers - (1 if cfg.layer == "penultimate" else 0))
    if layout != "open_clip":
        raise ValueError(layout)
    sd: dict[str, np.ndarray] = {
        "token_embedding.weight": _a(t["token_embedding"]["embedding"]),
        "positional_embedding": _a(t["positional_embedding"]),
    }
    _norm(sd, "ln_final", t["ln_final"])
    n_layers = cfg.layers - (1 if cfg.layer == "penultimate" else 0)
    for i in range(n_layers):
        tp, b = f"transformer.resblocks.{i}", t[f"resblock_{i}"]
        _norm(sd, f"{tp}.ln_1", b["ln_1"])
        _norm(sd, f"{tp}.ln_2", b["ln_2"])
        sd[f"{tp}.attn.in_proj_weight"] = _a(np.asarray(b["in_proj"]["kernel"]).T)
        sd[f"{tp}.attn.in_proj_bias"] = _a(b["in_proj"]["bias"])
        _linear(sd, f"{tp}.attn.out_proj", b["out_proj"])
        _linear(sd, f"{tp}.mlp.c_fc", b["c_fc"])
        _linear(sd, f"{tp}.mlp.c_proj", b["c_proj"])
    return sd


def from_jax_legacy(params: Tree) -> dict[str, np.ndarray]:
    """A JAX ``LegacyResidualBlock`` or ``LegacyAttentionBlock`` tree ->
    the state dict of the port's block of the same configuration
    (``models/legacy.py``, whose modules carry the JAX names)."""
    sd: dict[str, np.ndarray] = {}
    for name, t in _unwrap(params).items():
        if "GroupNorm_0" in t:
            _gn32(sd, name, t)
        elif np.ndim(t["kernel"]) == 4:
            _conv2d(sd, name, t)
        else:
            _linear(sd, name, t)
    return sd


def lora_from_jax(tree: Mapping[str, Mapping[str, Any]], device="cpu") -> dict:
    """A JAX LoRA tree (``{name: {"lora_A" (in, r), "lora_B" (r, out)[,
    "scale", "diag"]}}``, numpy leaves) -> the port's: the same names and
    layouts (the port's merge transposes the (in, out) delta onto the
    ``nn.Linear`` weight), float32 tensors that ask for gradients."""
    def leaf(k, v):
        if np.ndim(v) == 0:
            return float(v)
        return torch.tensor(np.asarray(v, np.float32), device=device,
                            requires_grad=k in ("lora_A", "lora_B"))

    return {name: {k: leaf(k, v) for k, v in ab.items()} for name, ab in tree.items()}


def lora_to_jax(lora: Mapping[str, Mapping[str, Any]]) -> dict:
    """The port's LoRA tree -> the JAX package's, numpy float32 leaves."""
    def leaf(v):
        return v.detach().float().cpu().numpy() if torch.is_tensor(v) else np.float32(v)

    return {name: {k: leaf(v) for k, v in ab.items()} for name, ab in lora.items()}


def load_torch_checkpoint(path: str) -> dict:
    """A torch zip checkpoint (.pth / .bin / .ckpt) as a dict of CPU
    tensors, memory-mapped (nothing is read until a tensor is used) and
    through torch's weights-only unpickler, which refuses any global but
    containers, tensors and dtypes. Tensors keep their stored dtype. A file
    that pickles another global (a Lightning checkpoint's
    ``hyper_parameters`` object, say) raises ``ValueError`` naming it."""
    import pickle
    import re

    try:
        return torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    except pickle.UnpicklingError as e:
        blocked = re.search(r"GLOBAL (\S+)", str(e))
        raise ValueError(
            f"{path}: the checkpoint pickles "
            f"{blocked.group(1) if blocked else 'an object'}, which the weights-only reader "
            "refuses; save the checkpoint's tensors without it") from None


def strip_first_stage_prefix(sd: Mapping) -> dict:
    """``VQGAN_autoencoder.pth`` wraps everything under a top-level
    'state_dict' key and carries 'first_stage_model.' prefixes; the
    reference keeps only the prefixed keys' suffixes and discards the
    ``loss.*`` keys."""
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    out = {}
    for k, v in sd.items():
        if "first_stage_model" in k:
            k = k.split("first_stage_model.")[-1]
        if k.startswith("loss."):
            continue
        out[k] = v
    return out


@torch.no_grad()
def load_state(module: torch.nn.Module, sd: Mapping[str, torch.Tensor], *,
               dtype: torch.dtype, device: torch.device | str) -> torch.nn.Module:
    """Load the keys of ``sd`` that ``module`` owns, each cast to ``dtype``
    on ``device`` one tensor at a time, in place of the module's own tensors
    (so the module may be built on the meta device). The copies own their
    memory: nothing stays mapped to the file. Every key the module
    owns must be present; other keys (a text tower's visual half, a VAE's
    loss network) are ignored."""
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"state dict lacks {len(missing)} keys, e.g. {missing[:3]}")
    module.load_state_dict({k: sd[k].to(device=device, dtype=dtype, copy=True)
                           for k in own}, assign=True)
    return module


def load_into(module: torch.nn.Module, sd: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """Load the keys of ``sd`` that ``module`` has (every one of its own
    keys must be present), keeping the module's device and dtype."""
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"state dict lacks {len(missing)} keys, e.g. {missing[:3]}")
    module.load_state_dict(
        {k: torch.from_numpy(np.array(sd[k], np.float32)).to(own[k].dtype) for k in own}
    )
    return module
