"""Spatially tiled VAE decode and encode with overlap blending.

The port of the JAX package's ``models/vae_tiled.py``: at high resolutions
(ZeroScope's 1024x576) the decoder runs on overlapping latent tiles whose
outputs are feather-blended, which bounds the decoder's activation memory
at any resolution. Frames stay batched, so tiling composes with the
pipeline's frame chunking. The blend runs in float32 on the tiles' device.

Each tile's mid-block attention sees ``tile²`` tokens of the 512-wide head:
the flash kernel takes it from 512 tokens on (``FLASH_MIN_KV``), so tiles
of 23 latent pixels and up reach it, smaller ones the plain attention.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _ramp_weights(size: int, start_ovl: int, end_ovl: int) -> np.ndarray:
    """1-D feather: linear 0 -> 1 over the leading and trailing overlaps."""
    w = np.ones(size, np.float32)
    if start_ovl > 0:
        w[:start_ovl] = np.linspace(0.0, 1.0, start_ovl + 2)[1:-1]
    if end_ovl > 0:
        w[-end_ovl:] = np.linspace(1.0, 0.0, end_ovl + 2)[1:-1]
    return w


def _tile_starts(total: int, tile: int, stride: int) -> list[int]:
    if total <= tile:
        return [0]
    starts = list(range(0, total - tile, stride))
    starts.append(total - tile)
    return starts


def _blend_weight(h: int, w: int, y0: int, x0: int, th: int, tw: int, ovl: int,
                  total_h: int, total_w: int, device) -> torch.Tensor:
    """(1, h, w, 1) float32 feather of one tile: ramps on the sides that
    overlap a neighbour, flat on the image's edges."""
    wy = _ramp_weights(h, ovl if y0 > 0 else 0, ovl if y0 + th < total_h else 0)
    wx = _ramp_weights(w, ovl if x0 > 0 else 0, ovl if x0 + tw < total_w else 0)
    return torch.from_numpy(wy[:, None] * wx[None, :]).to(device)[None, :, :, None]


def decode_spatial_tiled(decode_fn: Callable, z: torch.Tensor, *, tile: int = 64,
                         overlap: int = 16, upscale: int = 8) -> torch.Tensor:
    """z: (F, h, w, C) unscaled latents -> (F, h*upscale, w*upscale, 3)
    float32 images. ``decode_fn`` maps a latent tile (F, th, tw, C) to
    (F, th*u, tw*u, 3); tiles are decoded one at a time and blended over
    ``overlap`` latent pixels."""
    f, h, w, _ = z.shape
    if h <= tile and w <= tile:
        return decode_fn(z).float()
    stride = tile - overlap
    out = norm = None
    for y0 in _tile_starts(h, tile, stride):
        for x0 in _tile_starts(w, tile, stride):
            th, tw = min(tile, h - y0), min(tile, w - x0)
            img = decode_fn(z[:, y0 : y0 + th, x0 : x0 + tw, :]).float()
            if out is None:
                out = img.new_zeros((f, h * upscale, w * upscale, img.shape[-1]))
                norm = img.new_zeros((1, h * upscale, w * upscale, 1))
            wt = _blend_weight(th * upscale, tw * upscale, y0, x0, th, tw, overlap * upscale,
                               h, w, img.device)
            ys, xs = y0 * upscale, x0 * upscale
            out[:, ys : ys + th * upscale, xs : xs + tw * upscale] += img * wt
            norm[:, ys : ys + th * upscale, xs : xs + tw * upscale] += wt
    return out / norm.clamp_min(1e-8)


def encode_spatial_tiled(encode_fn: Callable, x: torch.Tensor, *, tile: int = 512,
                         overlap: int = 128, downscale: int = 8) -> torch.Tensor:
    """x: (F, H, W, 3) images -> (F, H/d, W/d, C) float32 latent means,
    encoded on overlapping ``tile``-pixel tiles and blended over
    ``overlap // downscale`` latent pixels."""
    f, big_h, big_w, _ = x.shape
    if big_h <= tile and big_w <= tile:
        return encode_fn(x).float()
    stride = tile - overlap
    h, w = big_h // downscale, big_w // downscale
    od = overlap // downscale
    out = norm = None
    for y0 in _tile_starts(big_h, tile, stride):
        for x0 in _tile_starts(big_w, tile, stride):
            th, tw = min(tile, big_h - y0), min(tile, big_w - x0)
            lat = encode_fn(x[:, y0 : y0 + th, x0 : x0 + tw]).float()
            if out is None:
                out = lat.new_zeros((f, h, w, lat.shape[-1]))
                norm = lat.new_zeros((1, h, w, 1))
            lh, lw = lat.shape[1], lat.shape[2]
            wt = _blend_weight(lh, lw, y0, x0, th, tw, od, big_h, big_w, lat.device)
            ly, lx = y0 // downscale, x0 // downscale
            out[:, ly : ly + lh, lx : lx + lw] += lat * wt
            norm[:, ly : ly + lh, lx : lx + lw] += wt
    return out / norm.clamp_min(1e-8)
