"""VideoCrafter (LVDM) Lightning checkpoints -> the port's modules.

A ``model.ckpt`` is a Lightning checkpoint whose ``state_dict`` holds every
part under a prefix:
  model.diffusion_model.*        -> ``VideoCrafterUNet``
  first_stage_model.*            -> ``AutoencoderKL`` (the SD VAE)
  cond_stage_model.transformer.* -> ``HFCLIPTextModel`` (CLIP-L)
  cond_stage2_model.*            -> ``FPSEmbedder`` (FPS-conditioned models)
The port's modules carry these state-dict names (the UNet's 1x1 Conv3d
projections included), so loading a part is stripping its prefix and
``convert.load_state``: no layout conversion. The FPS embedder's class is
not published, so ``fps_embedder_state`` maps the two Linear layers it finds
under its prefix, in key order, as the JAX package's
``convert_fps_embedder`` does. ``vc_module_index`` is the UNet's LoRA target
index for ``pipeline/lora.py::merge_lvdm_lora``. ``lightning_state_dict``
and ``base_t2v_yaml`` go the other way: the modules and configs in the
published ``base_t2v`` layout.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from t2v_torch.core.config import VAEConfig, VideoCrafterUNetConfig
from t2v_torch.models.videocrafter_unet import build_vc_topology

PREFIXES = {"unet": "model.diffusion_model.", "vae": "first_stage_model.",
            "clip": "cond_stage_model.transformer."}
FPS_PREFIX = "cond_stage2_model."


def split_lightning_state_dict(ckpt: Mapping[str, Any]) -> dict[str, dict]:
    """A loaded ``model.ckpt`` -> {"unet", "vae", "clip", "other"} state
    dicts, each prefix stripped ("other" keeps every key it does not
    know, e.g. ``cond_stage2_model.*`` or an EMA's)."""
    sd = ckpt.get("state_dict", ckpt)
    out: dict[str, dict] = {"unet": {}, "vae": {}, "clip": {}, "other": {}}
    for k, v in sd.items():
        for part, prefix in PREFIXES.items():
            if k.startswith(prefix):
                out[part][k[len(prefix):]] = v
                break
        else:
            out["other"][k] = v
    return out


def vc_module_index(cfg: VideoCrafterUNetConfig) -> dict[str, tuple[str, str]]:
    """Every LVDM LoRA target of the UNet (the attention projections and
    feed-forward linears of each spatial-temporal transformer block) ->
    (its weight's name in the state dict, "linear"), in the JAX package's
    ``vc_module_index`` order."""
    idx: dict[str, tuple[str, str]] = {}
    topo = build_vc_topology(cfg)
    for entry in (*topo.encoder, topo.middle, *topo.decoder):
        for d in entry:
            if d.kind != "st":
                continue
            for dep in range(cfg.transformer_depth):
                tp = f"{d.torch_path}.transformer_blocks.{dep}"
                names = [f"{tp}.{attn}.{proj}" for attn in ("attn1", "attn2", "attn1_tmp",
                                                            "attn2_tmp")
                         for proj in ("to_q", "to_k", "to_v", "to_out.0")]
                for name in (*names, f"{tp}.ff.net.0.proj", f"{tp}.ff.net.2"):
                    idx[name] = (f"{name}.weight", "linear")
    return idx


def fps_embedder_state(other: Mapping[str, Any],
                       cfg: VideoCrafterUNetConfig) -> dict[str, Any] | None:
    """The ``FPSEmbedder`` state dict from a checkpoint's ``cond_stage2_model.*``
    keys: its two 2-D weights in key order (with their biases, zeros where
    absent) as ``fps_embed.0`` and ``fps_embed.2``. None when there are not
    exactly two or their shapes do not fit the config."""
    linears = [(k[:-len(".weight")], other[k]) for k in sorted(other)
               if k.startswith(FPS_PREFIX) and k.endswith(".weight") and other[k].dim() == 2]
    emb = cfg.model_channels * 4
    wants = ((emb, cfg.model_channels), (emb, emb))
    if len(linears) != 2 or any(tuple(w.shape) != want for (_, w), want in zip(linears, wants)):
        return None
    sd = {}
    for i, (path, w) in zip((0, 2), linears):
        sd[f"fps_embed.{i}.weight"] = w
        sd[f"fps_embed.{i}.bias"] = other.get(f"{path}.bias", torch.zeros(w.shape[0]))
    return sd


def from_jax_fps_embedder(params) -> dict[str, Any]:
    """The JAX package's ``FPSEmbedder`` parameters (numpy leaves) -> the
    port's state dict."""
    p = params["params"]
    sd = {}
    for i in (0, 2):
        sd[f"fps_embed.{i}.weight"] = p[f"fps_embed_{i}"]["kernel"].T
        sd[f"fps_embed.{i}.bias"] = p[f"fps_embed_{i}"]["bias"]
    return sd


def lightning_state_dict(unet, vae, clip, fps=None) -> dict[str, torch.Tensor]:
    """The ``state_dict`` of a published ``model.ckpt`` from the port's
    modules: each part's tensors under its prefix (an FPS embedder's under
    ``cond_stage2_model.``), floating ones in float32 on the CPU, and the
    ``position_ids`` buffer that HF CLIP checkpoints carry beside the text
    tower."""
    sd = {}
    parts = [(PREFIXES["unet"], unet), (PREFIXES["vae"], vae), (PREFIXES["clip"], clip)]
    if fps is not None:
        parts.append((FPS_PREFIX, fps))
    for prefix, module in parts:
        sd.update({prefix + k: v.float().cpu() if v.is_floating_point() else v.cpu()
                   for k, v in module.state_dict().items()})
    sd[PREFIXES["clip"] + "text_model.embeddings.position_ids"] = torch.arange(77)[None]
    return sd


def base_t2v_yaml(cfg: VideoCrafterUNetConfig, vae_cfg: VAEConfig, video_length: int = 16) -> str:
    """``model_config.yaml`` for ``cfg`` and ``vae_cfg`` in the layout of
    VideoCrafter's published ``base_t2v`` (comments, blank lines, block and
    flow lists), written as text; with a ``cond_stage2_config`` when ``cfg``
    is FPS-conditioned."""
    seq = lambda xs, pad: "".join(f"\n{pad}- {x}" for x in xs)
    fps = """
    cond_stage2_config:
      target: lvdm.models.modules.condition_modules.FPSEmbedder  # 'fps' conditioning
""" if cfg.cond_stage2_key == "temporal_context" else ""
    return f"""# VideoCrafter text2video
model:
  target: lvdm.models.ddpm3d.LatentDiffusion
  params:
    linear_start: {cfg.linear_start}
    linear_end: {cfg.linear_end}
    num_timesteps_cond: 1
    log_every_t: 200
    timesteps: {cfg.num_timesteps}
    first_stage_key: video
    cond_stage_key: caption
    image_size:
    - 32
    - 32
    video_length: {video_length}
    channels: 4
    cond_stage_trainable: false
    conditioning_key: {cfg.conditioning_key}
    monitor: val/loss_simple_ema
    scale_by_std: false
    scale_factor: {cfg.scale_factor}

    unet_config:
      target: lvdm.models.modules.openaimodel3d.UNetModel
      params:
        image_size: 32
        in_channels: {cfg.in_channels}
        out_channels: {cfg.out_channels}
        model_channels: {cfg.model_channels}
        attention_resolutions:{seq(cfg.attention_resolutions, "        ")}
        num_res_blocks: {cfg.num_res_blocks}
        channel_mult: [{", ".join(map(str, cfg.channel_mult))}]
        num_heads: {cfg.num_heads}
        transformer_depth: {cfg.transformer_depth}
        context_dim: {cfg.context_dim}
        use_checkpoint: true
        legacy: false
        kernel_size_t: {cfg.kernel_size_t}
        padding_t: {cfg.padding_t}
        temporal_length: {cfg.temporal_length}
        use_relative_position: {str(cfg.use_relative_position).lower()}

    first_stage_config:
      target: lvdm.models.autoencoder.AutoencoderKL
      params:
        embed_dim: 4
        monitor: val/rec_loss
        ddconfig:
          double_z: true
          z_channels: {vae_cfg.z_channels}
          resolution: {vae_cfg.resolution}
          in_channels: {vae_cfg.in_channels}
          out_ch: {vae_cfg.out_channels}
          ch: {vae_cfg.ch}
          ch_mult:{seq(vae_cfg.ch_mult, "          ")}
          num_res_blocks: {vae_cfg.num_res_blocks}
          attn_resolutions: []
          dropout: 0.0
        lossconfig:
          target: torch.nn.Identity

    cond_stage_config:
      target: lvdm.models.modules.condition_modules.FrozenCLIPEmbedder
{fps}"""
