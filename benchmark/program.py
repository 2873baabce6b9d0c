"""The system under test: the port's pipelines, built from a configuration
file with the benchmark's seeded weights.

The port is imported here and in the loops only, inside functions, so that
the reference and the rest of the harness load without it.
"""

from __future__ import annotations

import torch

from benchmark import weights
from benchmark.reference import modelscope, text, vae, videocrafter

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def latent_shape(cfg: dict, traffic: dict) -> tuple[int, int, int, int]:
    """(F, h, w, C) of one video's latent under the config's VAE."""
    down = 2 ** (len(cfg["vae"]["ch_mult"]) - 1)
    c = cfg["unet"]["in_dim"] if cfg["family"] == "modelscope" else cfg["unet"]["in_channels"]
    return traffic["frames"], traffic["height"] // down, traffic["width"] // down, c


def seeds(run_seed: int) -> dict:
    """The weight seeds of the three models of a run."""
    return {"unet": int(run_seed), "vae": int(run_seed) + 1, "text": int(run_seed) + 2}


def param_shapes(cfg: dict) -> dict:
    """(name, shape) lists of the UNet, the VAE and the text tower."""
    unet = modelscope if cfg["family"] == "modelscope" else videocrafter
    tower = text.openclip_shapes if cfg["family"] == "modelscope" else text.hfclip_shapes
    return {"unet": unet.param_shapes(cfg["unet"]), "vae": vae.param_shapes(cfg["vae"]),
            "text": tower(cfg["text"])}


def build(cfg: dict, run_seed: int, device) -> object:
    """The port's pipeline of ``cfg`` on ``device``, in the config's dtype,
    holding the seeded weights."""
    from t2v_torch.core.config import (CLIPTextConfig, ModelScopeUNetConfig, VAEConfig,
                                       VideoCrafterUNetConfig, config_from_dict)
    from t2v_torch.core.dtypes import Policy

    policy = Policy(param_dtype=DTYPES[cfg["dtype"]])
    vae_cfg = config_from_dict(VAEConfig, cfg["vae"])
    clip_cfg = config_from_dict(CLIPTextConfig, cfg["text"])
    if cfg["family"] == "modelscope":
        from t2v_torch.pipeline.pipeline import ModelScopePipeline

        pipe = ModelScopePipeline.random_init(
            config_from_dict(ModelScopeUNetConfig, cfg["unet"]), policy, device=device,
            vae_cfg=vae_cfg, clip_cfg=clip_cfg)
        tower = pipe.text_encoder.model
    else:
        from t2v_torch.pipeline.videocrafter import VideoCrafterPipeline

        # the port builds VideoCrafter's VAE from its own two presets
        pipe = VideoCrafterPipeline.random_init(
            config_from_dict(VideoCrafterUNetConfig, cfg["unet"]), policy, device=device,
            small_aux=vae_cfg != VAEConfig(), clip_cfg=clip_cfg)
        if pipe.vae_cfg != vae_cfg:
            raise ValueError(f"the port's VideoCrafter VAE is {pipe.vae_cfg}, the config's {vae_cfg}")
        tower = pipe.clip
    shapes, s = param_shapes(cfg), seeds(run_seed)
    for key, module in (("unet", pipe.unet), ("vae", pipe.vae), ("text", tower)):
        weights.load_into(module, shapes[key], s[key])
    return pipe


def reference_weights(cfg: dict, run_seed: int, device, dtype: torch.dtype) -> dict:
    """The same weights for the reference, float32 on ``device``: the values
    of ``dtype`` the program holds."""
    shapes, s = param_shapes(cfg), seeds(run_seed)
    return {k: weights.state_dict(shapes[k], s[k], device, dtype) for k in shapes}
