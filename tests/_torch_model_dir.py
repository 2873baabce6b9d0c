"""Tiny ModelScope model directories in the published layout, written from
a seeded port pipeline, for the port's loading and generation tests.

``write_model_dir`` saves what a published ModelScope directory holds:
``configuration.json`` (the UNet config with the reference's string
"True", and the ``ckpt_*`` names), ``text2video_pytorch_model.pth`` (a
plain state dict), ``VQGAN_autoencoder.pth`` (under ``state_dict`` with
``first_stage_model.`` prefixes and a ``loss.`` key), an open_clip
``open_clip_pytorch_model.bin`` (with its visual tower's and
``logit_scale`` keys and the last block, which the penultimate-layer tower
does not use) and the repo's small BPE merge list under the published
vocab name.
"""

import dataclasses
import json
import shutil
from pathlib import Path

import torch

from t2v_torch.core.config import CLIPTextConfig, ModelScopeUNetConfig, VAEConfig
from t2v_torch.pipeline.pipeline import ModelScopePipeline

VOCAB = Path(__file__).resolve().parent / "data" / "tokenizer_merges.txt.gz"
UNET_CFG = ModelScopeUNetConfig().tiny()
VAE_CFG = VAEConfig().tiny()
CLIP_CFG = dataclasses.replace(CLIPTextConfig.vit_h_14().tiny(), width=UNET_CFG.context_dim)


def source_pipeline(seed: int = 0) -> ModelScopePipeline:
    """A seeded float32 CPU pipeline at the tiny configs, its zero leaves
    perturbed (so that the UNet's output is not 0)."""
    pipe = ModelScopePipeline.random_init(UNET_CFG, seed=seed, device="cpu",
                                          vae_cfg=VAE_CFG, clip_cfg=CLIP_CFG)
    with torch.no_grad():
        for mod in (pipe.unet, pipe.vae, pipe.text_encoder.model):
            for p in mod.parameters():
                if not p.any():
                    p.add_(0.01)
    return pipe


def configuration(cfg: ModelScopeUNetConfig = UNET_CFG, temporal_attention="True") -> dict:
    return {"framework": "pytorch", "task": "text-to-video-synthesis", "model": {
        "type": "latent-text-to-video-synthesis",
        "model_args": {"ckpt_clip": "open_clip_pytorch_model.bin",
                       "ckpt_unet": "text2video_pytorch_model.pth",
                       "ckpt_autoencoder": "VQGAN_autoencoder.pth",
                       "max_frames": 16, "tiny_gpu": 1},
        "model_cfg": {"unet_in_dim": cfg.in_dim, "unet_dim": cfg.dim, "unet_y_dim": cfg.y_dim,
                      "unet_context_dim": cfg.context_dim, "unet_out_dim": cfg.out_dim,
                      "unet_dim_mult": list(cfg.dim_mult), "unet_num_heads": cfg.num_heads,
                      "unet_head_dim": cfg.head_dim, "unet_res_blocks": cfg.num_res_blocks,
                      "unet_attn_scales": list(cfg.attn_scales), "unet_dropout": cfg.dropout,
                      "temporal_attention": temporal_attention,
                      "num_timesteps": cfg.num_timesteps, "mean_type": cfg.parameterization},
    }}


def write_model_dir(pipe: ModelScopePipeline, out: Path, unet_dtype=torch.float32) -> Path:
    out.mkdir(parents=True, exist_ok=True)
    (out / "configuration.json").write_text(json.dumps(configuration(pipe.unet_cfg)))
    torch.save({k: v.to(unet_dtype) for k, v in pipe.unet.state_dict().items()},
               out / "text2video_pytorch_model.pth")
    vae = {f"first_stage_model.{k}": v for k, v in pipe.vae.state_dict().items()}
    vae["loss.logvar"] = torch.zeros(())
    torch.save({"state_dict": vae, "global_step": 7}, out / "VQGAN_autoencoder.pth")
    clip = dict(pipe.text_encoder.model.state_dict())
    n = pipe.clip_cfg.layers - 1  # the block the penultimate-layer tower drops
    clip.update({k.replace("resblocks.0.", f"resblocks.{n}."): v + 1.0
                 for k, v in clip.items() if k.startswith("transformer.resblocks.0.")})
    clip.update({"visual.conv1.weight": torch.ones(4, 3, 2, 2), "logit_scale": torch.tensor(4.6),
                 "text_projection": torch.ones(pipe.clip_cfg.width, 8)})
    torch.save(clip, out / "open_clip_pytorch_model.bin")
    shutil.copy(VOCAB, out / "bpe_simple_vocab_16e6.txt.gz")
    return out
