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
vocab name. ``write_vc_dir`` writes a VideoCrafter directory: a Lightning
``model.ckpt`` beside its ``model_config.yaml`` and the vocab.
"""

import dataclasses
import json
import shutil
from pathlib import Path

import torch

from t2v_torch.core.config import (
    CLIPTextConfig,
    ModelScopeUNetConfig,
    VAEConfig,
    VideoCrafterUNetConfig,
)
from t2v_torch.io.convert_vc import base_t2v_yaml, lightning_state_dict
from t2v_torch.pipeline.pipeline import ModelScopePipeline
from t2v_torch.pipeline.videocrafter import VideoCrafterPipeline
from t2v_torch.text.tokenizer import CLIPTokenizer

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


# ---------------------------------------------------------------------------
# VideoCrafter: a Lightning ``model.ckpt`` beside its ``model_config.yaml``

VC_UNET_CFG = dataclasses.replace(VideoCrafterUNetConfig().tiny(), context_dim=768)


def vc_source_pipeline(seed: int = 0, fps: bool = False) -> VideoCrafterPipeline:
    """A seeded float32 CPU VideoCrafter pipeline that a published-layout
    checkpoint can carry: the tiny UNet at CLIP-L's width (FPS-conditioned,
    with its embedder, when ``fps``), the tiny VAE and a one-layer CLIP-L
    tower (width 768, 12 heads, the published 49,408-row embedding, as both
    packages' loaders build it); the vocab file's tokenizer; zero leaves
    perturbed."""
    cfg = VC_UNET_CFG
    if fps:
        cfg = dataclasses.replace(cfg, cond_stage2_key="temporal_context")
    pipe = VideoCrafterPipeline.random_init(
        cfg, seed=seed, device="cpu", small_aux=True,
        clip_cfg=dataclasses.replace(CLIPTextConfig.clip_l_14(), layers=1))
    pipe.tokenizer = CLIPTokenizer.from_vocab_file(str(VOCAB))
    with torch.no_grad():
        for mod in (pipe.unet, pipe.vae, pipe.clip):
            for p in mod.parameters():
                if not p.any():
                    p.add_(0.01)
    return pipe


def small_vc_pipeline(seed: int = 0) -> VideoCrafterPipeline:
    """The tiny VideoCrafter pipeline of ``random_init`` (two-layer,
    32-wide text tower), with the vocab file's tokenizer and the published
    49,408-row embedding, so that a directory the trainer saves from it
    loads with its own vocab."""
    cfg = VideoCrafterUNetConfig().tiny()
    clip_cfg = dataclasses.replace(CLIPTextConfig.clip_l_14(), width=cfg.context_dim, layers=2,
                                   heads=2)
    pipe = VideoCrafterPipeline.random_init(cfg, seed=seed, device="cpu", clip_cfg=clip_cfg)
    pipe.tokenizer = CLIPTokenizer.from_vocab_file(str(VOCAB))
    return pipe


def vc_model_config(cfg: VideoCrafterUNetConfig, vae_cfg: VAEConfig, fps: bool = False) -> str:
    """``model_config.yaml`` in the published ``base_t2v`` layout, with a
    ``cond_stage2_config`` when ``fps``."""
    if fps:
        cfg = dataclasses.replace(cfg, cond_stage2_key="temporal_context")
    return base_t2v_yaml(cfg, vae_cfg)


def write_vc_dir(pipe: VideoCrafterPipeline, out: Path, fps: bool = False) -> Path:
    """A VideoCrafter directory in the published layout: ``model.ckpt``
    (float32, Lightning: ``lightning_state_dict`` with the pipeline's FPS
    embedder if it has one, and an EMA key in ``state_dict``, plus
    ``global_step`` / ``epoch``), ``model_config.yaml`` and the vocab."""
    out.mkdir(parents=True, exist_ok=True)
    (out / "model_config.yaml").write_text(vc_model_config(pipe.cfg, pipe.vae_cfg, fps))
    sd = lightning_state_dict(pipe.unet, pipe.vae, pipe.clip, pipe.fps_embedder)
    sd["model_ema.decay"] = torch.tensor(0.9999)
    torch.save({"state_dict": sd, "global_step": 7, "epoch": 1}, out / "model.ckpt")
    shutil.copy(VOCAB, out / "bpe_simple_vocab_16e6.txt.gz")
    return out


def write_clip_dir(root: Path, n_frames: int = 12, size=(40, 48), clips: int = 1) -> Path:
    """A WebVid directory of ``clips`` seeded clips (``videos/1.mp4``, ...
    and ``meta.csv``) for the trainer; needs ``cv2``."""
    import csv

    import cv2
    import numpy as np

    (root / "videos").mkdir(parents=True)
    rng = np.random.default_rng(0)
    h, w = size
    for i in range(1, clips + 1):
        writer = cv2.VideoWriter(str(root / "videos" / f"{i}.mp4"),
                                 cv2.VideoWriter_fourcc(*"mp4v"), 8, (w, h))
        for _ in range(n_frames):
            writer.write(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
        writer.release()
    with open(root / "meta.csv", "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["videoid", "name", "page_dir"])
        for i in range(1, clips + 1):
            wr.writerow([str(i), "a cat" if i == 1 else f"a cat, clip {i}", ""])
    return root
