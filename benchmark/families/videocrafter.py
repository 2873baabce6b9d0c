"""VideoCrafter ``base_t2v`` (AILab-CVC, LVDM ``UNetModel``): what the harness
needs of the family, found by the config's ``"family"``.

* the port's pipeline (``t2v_torch.pipeline.videocrafter.VideoCrafterPipeline``)
  built from the config, and the modules that hold each section's weights;
* the sections' parameter lists (the reference's names and shapes);
* what a request passes the port (``T2VArgs.model_type``, and ``infer``'s
  ``sample_type``: DDIM, as the traffic's sampler says);
* the plain float32 reference: the CLIP-L text context, the UNet with
  rel-pos temporal attention and the SD KL-f8 VAE (``benchmark/reference/``);
* the text tower's model operations (those of the UNet and the VAE follow
  from ``UNET`` and ``VAE``: ``benchmark/work/models.py``).

``UNET`` and ``VAE`` name the reference modules of the two models, which the
harness calls alike for every family: ``UNET.forward`` and
``UNET.param_shapes``; ``VAE.decode_frames``, ``VAE.encode_mean``, and for the
counts ``VAE.decode`` and the encoder's and decoder's shapes.
"""

from __future__ import annotations

from benchmark.reference import text, vae
from benchmark.reference import videocrafter as unet_ref

SECTIONS = ("unet", "vae", "text")
MODEL_TYPE = "VideoCrafter"
UNET, VAE = unet_ref, vae
INFER_KWARGS = {"sample_type": "ddim"}


def latent_channels(cfg: dict) -> int:
    return cfg["unet"]["in_channels"]


def param_shapes(cfg: dict) -> dict:
    return {"unet": unet_ref.param_shapes(cfg["unet"]), "vae": vae.param_shapes(cfg["vae"]),
            "text": text.hfclip_shapes(cfg["text"])}


def unet_config(cfg: dict):
    """The port's UNet configuration of ``cfg``."""
    from t2v_torch.core.config import VideoCrafterUNetConfig, config_from_dict

    return config_from_dict(VideoCrafterUNetConfig, cfg["unet"])


def build(cfg: dict, policy, device) -> tuple[object, dict]:
    """(the port's pipeline on ``device``, {section: the module holding its
    weights}), the weights still the port's own."""
    from t2v_torch.core.config import CLIPTextConfig, VAEConfig, config_from_dict
    from t2v_torch.pipeline.videocrafter import VideoCrafterPipeline

    vae_cfg = config_from_dict(VAEConfig, cfg["vae"])
    # the port builds VideoCrafter's VAE from its own two presets
    pipe = VideoCrafterPipeline.random_init(
        unet_config(cfg), policy, device=device, small_aux=vae_cfg != VAEConfig(),
        clip_cfg=config_from_dict(CLIPTextConfig, cfg["text"]))
    if pipe.vae_cfg != vae_cfg:
        raise ValueError(f"the port's VideoCrafter VAE is {pipe.vae_cfg}, the config's {vae_cfg}")
    return pipe, {"unet": pipe.unet, "vae": pipe.vae, "text": pipe.clip}


# ---------------------------------------------------------------- reference


def context(sd: dict, cfg: dict, tok, prompt: str, ops=None):
    """(1, 77, width) text conditioning of ``prompt``."""
    return text.videocrafter_context(sd["text"], cfg["text"], tok, prompt, ops)


# ---------------------------------------------------------------- work


def text_flops(cfg: dict) -> int:
    from benchmark.work.models import count, meta_params, tokens

    sd = meta_params(text.hfclip_shapes(cfg["text"]))
    return count(lambda: text.hfclip_forward(sd, cfg["text"], tokens()))
