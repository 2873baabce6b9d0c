"""KL-VAE decoder (the SD "VQGAN_autoencoder.pth" first-stage model) in
PyTorch: the decode path of the JAX package's ``models/vae.py``.

Frames are one channels-last ``(B·F, H, W, C)`` batch. Parameters carry the
reference state-dict names (``decoder.mid.attn_1.q.weight``,
``decoder.up.3.block.0.conv1.weight``, ``post_quant_conv.weight`` …). The
encoder (vid2vid) is not part of this module yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from t2v_torch.core.config import VAEConfig
from t2v_torch.kernels.attention import attention
from t2v_torch.models.blocks import Conv2d, group_norm


class Normalize(nn.GroupNorm):
    """GroupNorm(32, eps 1e-6) with float32 statistics; the SiLU that
    follows runs in the activation dtype, as in the JAX package."""

    def __init__(self, channels: int):
        super().__init__(32, channels, eps=1e-6)

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, 32, self.eps)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = Normalize(in_ch)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = Normalize(out_ch)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1)
        self.nin_shortcut = Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention with 1x1-conv projections; the
    head is the full channel width (512 in the SD VAE), scale C^-0.5."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = Normalize(channels)
        self.q = Conv2d(channels, channels, 1)
        self.k = Conv2d(channels, channels, 1)
        self.v = Conv2d(channels, channels, 1)
        self.proj_out = Conv2d(channels, channels, 1)

    def forward(self, x):
        b, h, w, c = x.shape
        hn = self.norm(x)
        q = self.q(hn).reshape(b, h * w, c)
        k = self.k(hn).reshape(b, h * w, c)
        v = self.v(hn).reshape(b, h * w, c)
        out = attention(q, k, v, scale=c ** -0.5)
        return x + self.proj_out(out.reshape(b, h, w, c))


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))


class _Mid(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.block_1 = ResnetBlock(ch, ch)
        self.attn_1 = AttnBlock(ch)
        self.block_2 = ResnetBlock(ch, ch)


class _UpLevel(nn.Module):
    def __init__(self, block_in: int, block_out: int, n_blocks: int, upsample: bool):
        super().__init__()
        self.block = nn.ModuleList(
            [ResnetBlock(block_in if j == 0 else block_out, block_out) for j in range(n_blocks)]
        )
        self.attn = nn.ModuleList()
        self.upsample = Upsample(block_out) if upsample else None


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        nm = len(cfg.ch_mult)
        block_in = cfg.ch * cfg.ch_mult[-1]
        if cfg.attn_resolutions:
            raise NotImplementedError("VAE attention at up-block resolutions")
        self.conv_in = Conv2d(cfg.z_channels, block_in, 3, padding=1)
        self.mid = _Mid(block_in)
        levels: list[_UpLevel | None] = [None] * nm
        for i in reversed(range(nm)):
            block_out = cfg.ch * cfg.ch_mult[i]
            levels[i] = _UpLevel(block_in, block_out, cfg.num_res_blocks + 1, i != 0)
            block_in = block_out
        self.up = nn.ModuleList(levels)
        self.norm_out = Normalize(block_in)
        self.conv_out = Conv2d(block_in, cfg.out_channels, 3, padding=1)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for i in reversed(range(len(self.up))):
            level = self.up[i]
            for block in level.block:
                h = block(h)
            if level.upsample is not None:
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class AutoencoderKL(nn.Module):
    """decode(z) -> rgb, channels-last, z unscaled (the caller divides by
    the latent scale factor)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.decoder = Decoder(cfg)
        self.post_quant_conv = Conv2d(cfg.embed_dim, cfg.z_channels, 1)

    def decode(self, z):
        dtype = self.post_quant_conv.weight.dtype
        return self.decoder(self.post_quant_conv(z.to(dtype)))

    def forward(self, z):
        return self.decode(z)


@torch.no_grad()
def decode_uint8(vae: AutoencoderKL, z: torch.Tensor, scale: float) -> torch.Tensor:
    """Scaled latents ``(N, h, w, 4)`` -> uint8 RGB ``(N, H, W, 3)``: latent
    unscale, decode, the tensor2vid normalisation clip((x+1)/2) and
    quantisation."""
    img = vae.decode(z * (1.0 / float(scale)))
    img = torch.clamp(img.float() * 0.5 + 0.5, 0.0, 1.0)
    return torch.round(img * 255.0).to(torch.uint8)
