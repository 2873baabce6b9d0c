"""Model operations of one call, counted from the configuration's shapes.

The plain reference runs on the meta device under
``torch.utils.flop_counter.FlopCounterMode``, which counts the matrix
products and convolutions it issues (2 operations a multiply-add) without
computing anything: the count follows the configuration, whatever kernels
the program runs. Which reference a configuration runs is its family's
(``benchmark/families/<family>.py``: its ``UNET`` and ``VAE`` modules, and
its ``text_flops``).
"""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import spec
from benchmark.reference import text


def meta(shape) -> torch.Tensor:
    return torch.empty(shape, device="meta")


def meta_params(shapes) -> dict:
    """A state dict of meta tensors from (name, shape) pairs."""
    return {k: meta(s) for k, s in shapes}


def tokens() -> torch.Tensor:
    """One 77-token chunk on the meta device."""
    return torch.zeros(1, text.CONTEXT, dtype=torch.long, device="meta")


def count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def unet_pass(ref, cfg_unet: dict, shape: tuple, ctx_len: int) -> int:
    """Operations of the reference UNet module ``ref`` on a (B, F, h, w, C)
    latent and a ``ctx_len``-token context."""
    sd = meta_params(ref.param_shapes(cfg_unet))
    ctx = meta((shape[0], ctx_len, cfg_unet["context_dim"]))
    return count(lambda: ref.forward(sd, cfg_unet, meta(shape), meta(shape[:1]), ctx))


def vae_pass(vae, cfg_vae: dict, frames: int, h: int, w: int, encode: bool) -> int:
    """Operations of the reference VAE module ``vae`` decoding ``frames``
    latents of h x w, or encoding as many images to them."""
    sd = meta_params(vae.encoder_shapes(cfg_vae) if encode else vae.decoder_shapes(cfg_vae))
    down = 2 ** (len(cfg_vae["ch_mult"]) - 1)
    if encode:
        x = meta((frames, h * down, w * down, cfg_vae["in_channels"]))
        return count(lambda: vae.encode_mean(sd, cfg_vae, x))
    return count(lambda: vae.decode(sd, cfg_vae, meta((frames, h, w, cfg_vae["z_channels"]))))


def _key(cfg: dict) -> str:
    return json.dumps(cfg, sort_keys=True)


@functools.lru_cache(maxsize=None)
def _unet(cfg_json: str, shape: tuple, ctx_len: int) -> int:
    cfg = json.loads(cfg_json)
    return unet_pass(spec.family(cfg).UNET, cfg["unet"], shape, ctx_len)


def unet_call(cfg: dict, shape: tuple, ctx_len: int = 77) -> int:
    """Operations of one UNet call on a (B, F, h, w, C) latent."""
    return _unet(_key(cfg), tuple(shape), ctx_len)


@functools.lru_cache(maxsize=None)
def _vae(cfg_json: str, frames: int, h: int, w: int, encode: bool) -> int:
    cfg = json.loads(cfg_json)
    return vae_pass(spec.family(cfg).VAE, cfg["vae"], frames, h, w, encode)


def vae_decode(cfg: dict, frames: int, h: int, w: int) -> int:
    """Operations of decoding ``frames`` latents of h x w."""
    return _vae(_key(cfg), frames, h, w, False)


def vae_encode(cfg: dict, frames: int, h: int, w: int) -> int:
    """Operations of encoding ``frames`` images to h x w latents."""
    return _vae(_key(cfg), frames, h, w, True)


@functools.lru_cache(maxsize=None)
def _text(cfg_json: str) -> int:
    cfg = json.loads(cfg_json)
    return spec.family(cfg).text_flops(cfg)


def text_chunk(cfg: dict) -> int:
    """Operations of encoding one 77-token chunk."""
    return _text(_key(cfg))
