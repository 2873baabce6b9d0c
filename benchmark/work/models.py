"""Model operations of one call, counted from the configuration's shapes.

The plain reference runs on the meta device under
``torch.utils.flop_counter.FlopCounterMode``, which counts the matrix
products and convolutions it issues (2 operations a multiply-add) without
computing anything: the count follows the configuration, whatever kernels
the program runs.
"""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import modelscope, text, vae, videocrafter


def _meta(shapes) -> dict:
    return {k: torch.empty(s, device="meta") for k, s in shapes}


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


@functools.lru_cache(maxsize=None)
def _unet(cfg_json: str, shape: tuple, ctx_len: int) -> int:
    cfg = json.loads(cfg_json)
    mod = modelscope if cfg["family"] == "modelscope" else videocrafter
    sd = _meta(mod.param_shapes(cfg["unet"]))
    ctx_dim = cfg["unet"]["context_dim"]
    x = torch.empty(shape, device="meta")
    t = torch.empty(shape[0], device="meta")
    ctx = torch.empty(shape[0], ctx_len, ctx_dim, device="meta")
    return _count(lambda: mod.forward(sd, cfg["unet"], x, t, ctx))


def unet_call(cfg: dict, shape: tuple, ctx_len: int = 77) -> int:
    """Operations of one UNet call on a (B, F, h, w, C) latent."""
    return _unet(json.dumps(cfg, sort_keys=True), tuple(shape), ctx_len)


@functools.lru_cache(maxsize=None)
def _vae(cfg_json: str, frames: int, h: int, w: int, encode: bool) -> int:
    cfg = json.loads(cfg_json)
    shapes = vae.encoder_shapes(cfg) if encode else vae.decoder_shapes(cfg)
    sd = _meta(shapes)
    down = 2 ** (len(cfg["ch_mult"]) - 1)
    if encode:
        x = torch.empty(frames, h * down, w * down, cfg["in_channels"], device="meta")
        return _count(lambda: vae.encode_mean(sd, cfg, x))
    z = torch.empty(frames, h, w, cfg["z_channels"], device="meta")
    return _count(lambda: vae.decode(sd, cfg, z))


def vae_decode(cfg: dict, frames: int, h: int, w: int) -> int:
    """Operations of decoding ``frames`` latents of h x w."""
    return _vae(json.dumps(cfg["vae"], sort_keys=True), frames, h, w, False)


def vae_encode(cfg: dict, frames: int, h: int, w: int) -> int:
    """Operations of encoding ``frames`` images to h x w latents."""
    return _vae(json.dumps(cfg["vae"], sort_keys=True), frames, h, w, True)


@functools.lru_cache(maxsize=None)
def _text(cfg_json: str) -> int:
    cfg = json.loads(cfg_json)
    tokens = torch.zeros(1, text.CONTEXT, dtype=torch.long, device="meta")
    if cfg["family"] == "modelscope":
        sd = _meta(text.openclip_shapes(cfg["text"]))
        return _count(lambda: text.openclip_forward(sd, cfg["text"], tokens))
    sd = _meta(text.hfclip_shapes(cfg["text"]))
    return _count(lambda: text.hfclip_forward(sd, cfg["text"], tokens))


def text_chunk(cfg: dict) -> int:
    """Operations of encoding one 77-token chunk."""
    return _text(json.dumps(cfg, sort_keys=True))
