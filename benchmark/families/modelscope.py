"""ModelScope text-to-video (damo-vilab, ``UNetSD``): what the harness needs
of the family, found by the config's ``"family"``.

* the port's pipeline (``t2v_torch.pipeline.pipeline.ModelScopePipeline``)
  built from the config, and the modules that hold each section's weights;
* the sections' parameter lists (the reference's names and shapes), which
  the benchmark draws one set of weights from for both sides;
* what a request passes the port (``T2VArgs.model_type``, ``infer``'s
  keyword arguments);
* the plain float32 reference: the OpenCLIP ViT-H-14 text context, the UNet
  and the SD KL-f8 VAE (``benchmark/reference/``);
* the text tower's model operations (those of the UNet and the VAE follow
  from ``UNET`` and ``VAE``: ``benchmark/work/models.py``).

``UNET`` and ``VAE`` name the reference modules of the two models, which the
harness calls alike for every family: ``UNET.forward`` and
``UNET.param_shapes``; ``VAE.decode_frames``, ``VAE.encode_mean``, and for the
counts ``VAE.decode`` and the encoder's and decoder's shapes.
"""

from __future__ import annotations

from benchmark.reference import modelscope as unet_ref
from benchmark.reference import text, vae

SECTIONS = ("unet", "vae", "text")
MODEL_TYPE = "ModelScope"
UNET, VAE = unet_ref, vae
INFER_KWARGS: dict = {}


def latent_channels(cfg: dict) -> int:
    return cfg["unet"]["in_dim"]


def param_shapes(cfg: dict) -> dict:
    return {"unet": unet_ref.param_shapes(cfg["unet"]), "vae": vae.param_shapes(cfg["vae"]),
            "text": text.openclip_shapes(cfg["text"])}


def unet_config(cfg: dict):
    """The port's UNet configuration of ``cfg``."""
    from t2v_torch.core.config import ModelScopeUNetConfig, config_from_dict

    return config_from_dict(ModelScopeUNetConfig, cfg["unet"])


def build(cfg: dict, policy, device) -> tuple[object, dict]:
    """(the port's pipeline on ``device``, {section: the module holding its
    weights}), the weights still the port's own."""
    from t2v_torch.core.config import CLIPTextConfig, VAEConfig, config_from_dict
    from t2v_torch.pipeline.pipeline import ModelScopePipeline

    pipe = ModelScopePipeline.random_init(
        unet_config(cfg), policy, device=device, vae_cfg=config_from_dict(VAEConfig, cfg["vae"]),
        clip_cfg=config_from_dict(CLIPTextConfig, cfg["text"]))
    return pipe, {"unet": pipe.unet, "vae": pipe.vae, "text": pipe.text_encoder.model}


# ---------------------------------------------------------------- reference


def context(sd: dict, cfg: dict, tok, prompt: str, ops=None):
    """(1, 77, width) text conditioning of ``prompt``."""
    return text.modelscope_context(sd["text"], cfg["text"], tok, prompt, ops)


# ---------------------------------------------------------------- work


def text_flops(cfg: dict) -> int:
    from benchmark.work.models import count, meta_params, tokens

    sd = meta_params(text.openclip_shapes(cfg["text"]))
    return count(lambda: text.openclip_forward(sd, cfg["text"], tokens()))
