"""Plain float32 reference of the Stable Diffusion KL-f8 autoencoder
(CompVis latent-diffusion ``AutoencoderKL``: ResNet blocks with
GroupNorm(32, eps 1e-6) and SiLU, single-head attention in the middle
blocks, nearest 2x upsampling, stride-2 downsampling after a (0, 1) pad),
channels-last. Parameter names are the published state dict's; the
configuration is the ``vae`` dict of the benchmark's config file.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import layers as L
from benchmark.reference.ops import Ops


def _resnet_shapes(p, cin, cout):
    out = [*L.norm_shapes(f"{p}.norm1", cin), *L.conv_shapes(f"{p}.conv1", cin, cout, (3, 3)),
           *L.norm_shapes(f"{p}.norm2", cout), *L.conv_shapes(f"{p}.conv2", cout, cout, (3, 3))]
    return out + (L.conv_shapes(f"{p}.nin_shortcut", cin, cout, (1, 1)) if cin != cout else [])


def _attn_shapes(p, c):
    return [*L.norm_shapes(f"{p}.norm", c)] + [
        s for q in ("q", "k", "v", "proj_out") for s in L.conv_shapes(f"{p}.{q}", c, c, (1, 1))]


def _mid_shapes(p, c):
    return [*_resnet_shapes(f"{p}.block_1", c, c), *_attn_shapes(f"{p}.attn_1", c),
            *_resnet_shapes(f"{p}.block_2", c, c)]


def _levels(cfg, decoder: bool):
    """(index, block_in, block_out, n_blocks, attn, resample) per level."""
    ch, mult, nm = cfg["ch"], list(cfg["ch_mult"]), len(cfg["ch_mult"])
    attn_res = list(cfg["attn_resolutions"])
    out = []
    if decoder:
        block_in, res = ch * mult[-1], cfg["resolution"] // 2 ** (nm - 1)
        for i in reversed(range(nm)):
            out.append((i, block_in, ch * mult[i], cfg["num_res_blocks"] + 1, res in attn_res, i != 0))
            block_in = ch * mult[i]
            res *= 2 if i != 0 else 1
    else:
        block_in, res = ch, cfg["resolution"]
        for i, m in enumerate(mult):
            out.append((i, block_in, ch * m, cfg["num_res_blocks"], res in attn_res, i != nm - 1))
            block_in = ch * m
            res //= 2 if i != nm - 1 else 1
    return out


def decoder_shapes(cfg: dict):
    top = cfg["ch"] * cfg["ch_mult"][-1]
    out = [*L.conv_shapes("post_quant_conv", cfg["embed_dim"], cfg["z_channels"], (1, 1)),
           *L.conv_shapes("decoder.conv_in", cfg["z_channels"], top, (3, 3)), *_mid_shapes("decoder.mid", top)]
    for i, cin, cout, n, attn, up in _levels(cfg, True):
        for j in range(n):
            out += _resnet_shapes(f"decoder.up.{i}.block.{j}", cin if j == 0 else cout, cout)
            out += _attn_shapes(f"decoder.up.{i}.attn.{j}", cout) if attn else []
        out += L.conv_shapes(f"decoder.up.{i}.upsample.conv", cout, cout, (3, 3)) if up else []
    c = cfg["ch"] * cfg["ch_mult"][0]
    return out + [*L.norm_shapes("decoder.norm_out", c),
                  *L.conv_shapes("decoder.conv_out", c, cfg["out_channels"], (3, 3))]


def encoder_shapes(cfg: dict):
    out = L.conv_shapes("encoder.conv_in", cfg["in_channels"], cfg["ch"], (3, 3))
    for i, cin, cout, n, attn, down in _levels(cfg, False):
        for j in range(n):
            out += _resnet_shapes(f"encoder.down.{i}.block.{j}", cin if j == 0 else cout, cout)
            out += _attn_shapes(f"encoder.down.{i}.attn.{j}", cout) if attn else []
        out += L.conv_shapes(f"encoder.down.{i}.downsample.conv", cout, cout, (3, 3)) if down else []
    top = cfg["ch"] * cfg["ch_mult"][-1]
    z = cfg["z_channels"] * (2 if cfg["double_z"] else 1)
    return out + [*_mid_shapes("encoder.mid", top), *L.norm_shapes("encoder.norm_out", top),
                  *L.conv_shapes("encoder.conv_out", top, z, (3, 3)),
                  *L.conv_shapes("quant_conv", 2 * cfg["z_channels"], 2 * cfg["embed_dim"], (1, 1))]


def param_shapes(cfg: dict):
    return decoder_shapes(cfg) + encoder_shapes(cfg)


def _resnet(ops, sd, p, x):
    h = L.conv2d(ops, sd, f"{p}.conv1", L.gn(sd, f"{p}.norm1", x, 1e-6, True), padding=1)
    h = L.conv2d(ops, sd, f"{p}.conv2", L.gn(sd, f"{p}.norm2", h, 1e-6, True), padding=1)
    if f"{p}.nin_shortcut.weight" in sd:
        x = L.conv2d(ops, sd, f"{p}.nin_shortcut", x)
    return x + h


def _attn(ops, sd, p, x):
    b, h, w, c = x.shape
    hn = L.gn(sd, f"{p}.norm", x, 1e-6)
    q, k, v = (L.conv2d(ops, sd, f"{p}.{n}", hn).reshape(b, h * w, c) for n in "qkv")
    o = ops.attention(q, k, v, c ** -0.5)
    return x + L.conv2d(ops, sd, f"{p}.proj_out", o.reshape(b, h, w, c))


def _mid(ops, sd, p, x):
    return _resnet(ops, sd, f"{p}.block_2", _attn(ops, sd, f"{p}.attn_1", _resnet(ops, sd, f"{p}.block_1", x)))


def decode(sd, cfg: dict, z, ops: Ops | None = None):
    """Unscaled latents (N, h, w, z) -> images (N, H, W, 3) in about [-1, 1]."""
    ops = ops or Ops()
    h = L.conv2d(ops, sd, "decoder.conv_in", L.conv2d(ops, sd, "post_quant_conv", z.float()), padding=1)
    h = _mid(ops, sd, "decoder.mid", h)
    for i, _, _, n, attn, up in _levels(cfg, True):
        for j in range(n):
            h = _resnet(ops, sd, f"decoder.up.{i}.block.{j}", h)
            if attn:
                h = _attn(ops, sd, f"decoder.up.{i}.attn.{j}", h)
        if up:
            h = L.conv2d(ops, sd, f"decoder.up.{i}.upsample.conv", L.upsample_nearest(h), padding=1)
    return L.conv2d(ops, sd, "decoder.conv_out", L.gn(sd, "decoder.norm_out", h, 1e-6, True), padding=1)


def encode_mean(sd, cfg: dict, x, ops: Ops | None = None):
    """Images (N, H, W, 3) in [-1, 1] -> the posterior mean (N, h, w, z)."""
    ops = ops or Ops()
    h = L.conv2d(ops, sd, "encoder.conv_in", x.float(), padding=1)
    for i, _, _, n, attn, down in _levels(cfg, False):
        for j in range(n):
            h = _resnet(ops, sd, f"encoder.down.{i}.block.{j}", h)
            if attn:
                h = _attn(ops, sd, f"encoder.down.{i}.attn.{j}", h)
        if down:
            h = L.conv2d(ops, sd, f"encoder.down.{i}.downsample.conv", F.pad(h, (0, 0, 0, 1, 0, 1)), stride=2)
    h = _mid(ops, sd, "encoder.mid", h)
    h = L.conv2d(ops, sd, "encoder.conv_out", L.gn(sd, "encoder.norm_out", h, 1e-6, True), padding=1)
    return L.conv2d(ops, sd, "quant_conv", h).chunk(2, dim=-1)[0]


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    """[-1, 1] images -> uint8: clip((x + 1) / 2) and round(x · 255)."""
    return torch.round(torch.clamp(img.float() * 0.5 + 0.5, 0.0, 1.0) * 255.0).to(torch.uint8)


def decode_frames(sd, cfg: dict, latents, scale: float, ops: Ops | None = None, chunk: int = 8):
    """Scaled latents (F, h, w, 4) -> uint8 frames (F, H, W, 3), ``chunk``
    frames at a time."""
    return torch.cat([to_uint8(decode(sd, cfg, latents[i:i + chunk] / scale, ops))
                      for i in range(0, latents.shape[0], chunk)])
