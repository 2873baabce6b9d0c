"""KL-VAE (the SD "VQGAN_autoencoder.pth" first-stage model) in PyTorch:
the port of the JAX package's ``models/vae.py``, encoder and decoder.

Frames are one channels-last ``(B·F, H, W, C)`` batch. Parameters carry the
reference state-dict names (``encoder.down.0.block.0.conv1.weight``,
``decoder.mid.attn_1.q.weight``, ``quant_conv.weight``,
``post_quant_conv.weight`` …). ``encode`` returns the posterior's (mean,
logvar) with the logvar clipped to [-30, 20]; ``DiagonalGaussian`` wraps the
pair for sample / kl / nll / mode; ``encode_latents`` is the training
path's deterministic encode (posterior mean x latent scale, float32).

``cfg.attn_resolutions`` adds an ``AttnBlock`` after every ResnetBlock of a
level at those resolutions (encoder levels from ``cfg.resolution`` down,
decoder levels from the latent resolution up). Their heads are the level's
width (128 or 256 channels in the SD VAE's layout), which the flash kernel
does not take, so they run the plain attention at dispatch, as the JAX
package leaves them to XLA. No shipped config sets them.
"""

from __future__ import annotations

import math

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
    head is the full channel width (512 in the SD VAE's mid-block), scale
    C^-0.5."""

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


class Downsample(nn.Module):
    """Stride-2 conv3x3 after SD's asymmetric (0, 1) x (0, 1) padding."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class _Mid(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.block_1 = ResnetBlock(ch, ch)
        self.attn_1 = AttnBlock(ch)
        self.block_2 = ResnetBlock(ch, ch)


class _Level(nn.Module):
    """``n_blocks`` ResnetBlocks, each followed by an AttnBlock when
    ``attn``, then the level's resampler (``downsample`` / ``upsample``)."""

    def __init__(self, block_in: int, block_out: int, n_blocks: int, attn: bool):
        super().__init__()
        self.block = nn.ModuleList(
            [ResnetBlock(block_in if j == 0 else block_out, block_out) for j in range(n_blocks)]
        )
        self.attn = nn.ModuleList([AttnBlock(block_out) for _ in range(n_blocks)] if attn else [])

    def blocks(self, h):
        for j, block in enumerate(self.block):
            h = block(h)
            if self.attn:
                h = self.attn[j](h)
        return h


class _UpLevel(_Level):
    def __init__(self, block_in: int, block_out: int, n_blocks: int, upsample: bool,
                 attn: bool = False):
        super().__init__(block_in, block_out, n_blocks, attn)
        self.upsample = Upsample(block_out) if upsample else None


class _DownLevel(_Level):
    def __init__(self, block_in: int, block_out: int, n_blocks: int, downsample: bool,
                 attn: bool = False):
        super().__init__(block_in, block_out, n_blocks, attn)
        self.downsample = Downsample(block_out) if downsample else None


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        nm = len(cfg.ch_mult)
        self.conv_in = Conv2d(cfg.in_channels, cfg.ch, 3, padding=1)
        block_in, res = cfg.ch, cfg.resolution
        levels = []
        for i, mult in enumerate(cfg.ch_mult):
            block_out = cfg.ch * mult
            levels.append(_DownLevel(block_in, block_out, cfg.num_res_blocks, i != nm - 1,
                                     res in cfg.attn_resolutions))
            block_in = block_out
            res //= 2 if i != nm - 1 else 1
        self.down = nn.ModuleList(levels)
        self.mid = _Mid(block_in)
        self.norm_out = Normalize(block_in)
        out_ch = cfg.z_channels * (2 if cfg.double_z else 1)
        self.conv_out = Conv2d(block_in, out_ch, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x.to(self.conv_in.weight.dtype))
        for level in self.down:
            h = level.blocks(h)
            if level.downsample is not None:
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        nm = len(cfg.ch_mult)
        block_in = cfg.ch * cfg.ch_mult[-1]
        res = cfg.resolution // 2 ** (nm - 1)
        self.conv_in = Conv2d(cfg.z_channels, block_in, 3, padding=1)
        self.mid = _Mid(block_in)
        levels: list[_UpLevel | None] = [None] * nm
        for i in reversed(range(nm)):
            block_out = cfg.ch * cfg.ch_mult[i]
            levels[i] = _UpLevel(block_in, block_out, cfg.num_res_blocks + 1, i != 0,
                                 res in cfg.attn_resolutions)
            block_in = block_out
            res *= 2 if i != 0 else 1
        self.up = nn.ModuleList(levels)
        self.norm_out = Normalize(block_in)
        self.conv_out = Conv2d(block_in, cfg.out_channels, 3, padding=1)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for i in reversed(range(len(self.up))):
            level = self.up[i]
            h = level.blocks(h)
            if level.upsample is not None:
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class DiagonalGaussian:
    """Diagonal-Gaussian posterior over latents: sample / kl / nll / mode on
    a channels-last (mean, logvar) pair, the logvar clipped to [-30, 20] by
    ``AutoencoderKL.encode``. ``deterministic=True`` zeroes the variance."""

    def __init__(self, mean, logvar, deterministic: bool = False):
        self.mean = mean
        self.logvar = logvar
        self.deterministic = deterministic
        if deterministic:
            self.var = self.std = torch.zeros_like(mean)
        else:
            self.std = torch.exp(0.5 * logvar)
            self.var = torch.exp(logvar)

    def sample(self, generator: torch.Generator | None = None, noise=None):
        if self.deterministic:
            return self.mean
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator, device=self.mean.device,
                                dtype=self.mean.dtype)
        return self.mean + self.std * noise

    def kl(self, other: "DiagonalGaussian | None" = None):
        """KL to N(0, I) or to another diagonal Gaussian, summed over every
        axis but the batch."""
        if self.deterministic:
            return self.mean.new_zeros((self.mean.shape[0],))
        axes = tuple(range(1, self.mean.dim()))
        if other is None:
            return 0.5 * torch.sum(self.mean ** 2 + self.var - 1.0 - self.logvar, dim=axes)
        return 0.5 * torch.sum(
            (self.mean - other.mean) ** 2 / other.var + self.var / other.var - 1.0
            - self.logvar + other.logvar, dim=axes)

    def nll(self, sample):
        if self.deterministic:
            return self.mean.new_zeros((self.mean.shape[0],))
        axes = tuple(range(1, self.mean.dim()))
        return 0.5 * torch.sum(
            math.log(2.0 * math.pi) + self.logvar + (sample - self.mean) ** 2 / self.var,
            dim=axes)

    def mode(self):
        return self.mean


class AutoencoderKL(nn.Module):
    """encode(x) -> (mean, logvar); decode(z) -> rgb. Channels-last, x in
    [-1, 1], z unscaled (the caller divides by the latent scale factor)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.decoder = Decoder(cfg)
        self.post_quant_conv = Conv2d(cfg.embed_dim, cfg.z_channels, 1)
        self.encoder = Encoder(cfg)
        self.quant_conv = Conv2d(2 * cfg.z_channels, 2 * cfg.embed_dim, 1)

    def encode(self, x):
        moments = self.quant_conv(self.encoder(x))
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z):
        dtype = self.post_quant_conv.weight.dtype
        return self.decoder(self.post_quant_conv(z.to(dtype)))

    def forward(self, z):
        return self.decode(z)


@torch.no_grad()
def encode_latents(vae: AutoencoderKL, x: torch.Tensor, scale: float) -> torch.Tensor:
    """Images ``(N, H, W, 3)`` in [-1, 1] -> scaled posterior-mean latents
    ``(N, h, w, 4)`` in float32 (the deterministic encode of training and
    vid2vid)."""
    mean, _ = vae.encode(x)
    return mean.float() * float(scale)


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    """Decoded images in [-1, 1] -> uint8 RGB: the tensor2vid normalisation
    clip((x+1)/2) and quantisation."""
    img = torch.clamp(img.float() * 0.5 + 0.5, 0.0, 1.0)
    return torch.round(img * 255.0).to(torch.uint8)


@torch.no_grad()
def decode_uint8(vae: AutoencoderKL, z: torch.Tensor, scale: float) -> torch.Tensor:
    """Scaled latents ``(N, h, w, 4)`` -> uint8 RGB ``(N, H, W, 3)``: latent
    unscale, decode and ``to_uint8``."""
    return to_uint8(vae.decode(z * (1.0 / float(scale))))
