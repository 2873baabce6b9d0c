"""PyTorch building blocks of the ModelScope 3D-factorised UNet.

The port of the JAX package's ``models/blocks.py``. Layouts and numerics
are the JAX package's, module names are the reference torch checkpoint's:

* activations are channels-last: spatial tensors ``(B·F, H, W, C)`` and
  temporal tensors ``(B·H·W, F, C)``, contiguous; a convolution runs on
  the NCHW view of that memory (a ``channels_last`` tensor), so no layout
  copy surrounds it;
* normalisation statistics, LayerNorm and softmax are float32 whatever the
  compute dtype; GELU is the exact (erf) variant, computed in the compute
  dtype inside GEGLU;
* GroupNorm eps is 1e-5 in the ResBlock and TemporalConvBlock, 1e-6 in the
  transformer norms;
* parameters are named as in the reference state dict
  (``in_layers.2.weight``, ``temopral_conv.conv1.2.weight``,
  ``transformer_blocks.0.attn1.to_q.weight`` …), held in the reference
  torch layouts (Linear (out, in), Conv2d (out, in, kh, kw), Conv3d
  (out, in, 3, 1, 1), Conv1d (out, in, 1)). Modules that only fill a slot
  of those names (SiLU, Dropout) are never called.

The decoder's skip concat is a plain ``torch.cat``: the JAX package's
virtual concat pair (joint-stats GroupNorm + SplitConv) saves TPU memory
and computes the same function.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from t2v_torch.kernels.attention import (
    attention_mh,
    cross_attention_packed,
    self_attention_packed,
)
from t2v_torch.kernels.temporal_conv import temporal_conv_chain


def sinusoidal_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Timestep embedding, cos then sin; the frequency table is built in
    float64 and rounded once to float32."""
    half = dim // 2
    freqs = torch.from_numpy(
        np.power(10000.0, -np.arange(half, dtype=np.float64) / half).astype(np.float32)
    ).to(t.device)
    sinusoid = t.float()[:, None] * freqs[None, :]
    x = torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=1)
    if dim % 2 != 0:
        x = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
    return x


def group_norm(x, weight, bias, groups: int, eps: float, silu: bool = False, sp=None):
    """GroupNorm over a channels-last tensor ``(B, ..., C)``: statistics per
    sample over every middle axis and the group's channels, in float32,
    variance as E[x^2] - E[x]^2. Returns x's dtype. With ``sp`` (a mesh
    axis over which the frames of x are split) the float32 sums and sums
    of squares are all-reduced over it first, so the statistics span every
    rank's frames."""
    b, c = x.shape[0], x.shape[-1]
    x32 = x.float().reshape(b, -1, groups, c // groups)
    if sp is None:
        mean = x32.mean(dim=(1, 3), keepdim=True)
        var = (x32 * x32).mean(dim=(1, 3), keepdim=True) - mean * mean
    else:
        sums = sp.all_reduce_sum(torch.stack([x32.sum(dim=(1, 3)), (x32 * x32).sum(dim=(1, 3))]))
        sums = sums[:, :, None, :, None] / (x32.shape[1] * x32.shape[3] * sp.size)
        mean, var = sums[0], sums[1] - sums[0] * sums[0]
    y = (x32 - mean) * torch.rsqrt(var.clamp_min(0.0) + eps)
    y = y.reshape(x.shape) * weight.float() + bias.float()
    if silu:
        y = F.silu(y)
    return y.to(x.dtype)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32) on channels-last input with float32 statistics;
    ``silu=True`` applies the SiLU that follows most UNet norms."""

    def __init__(self, channels: int, eps: float = 1e-5, silu: bool = False):
        super().__init__(32, channels, eps=eps)
        self.silu = silu

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps, self.silu)


class FrameGroupNorm32(GroupNorm32):
    """GroupNorm32 on (B, F, ..., C) input whose statistics span the frames
    (VideoCrafter's norms). Under ``sp`` each rank holds its frames and the
    statistics are all-reduced over the axis."""

    sp = None  # the mesh axis splitting the frames (parallel/sharding.py)

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps, self.silu, self.sp)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm computed in float32, returned in the input dtype."""

    def forward(self, x):
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(), self.bias.float(), self.eps
        ).to(x.dtype)


class Conv2d(nn.Conv2d):
    """Conv2d on channels-last ``(B, H, W, C)`` tensors: runs on the NCHW
    view of that memory and returns ``(B, H', W', C')`` contiguous."""

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias, self.stride, self.padding)
        return y.permute(0, 2, 3, 1).contiguous()


def conv1x1_as_linear(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A Conv1d of kernel 1 applied per token: a Linear over the last axis."""
    return F.linear(x, conv.weight[:, :, 0], conv.bias)


def row_parallel(linear: nn.Linear, x: torch.Tensor, tp=None) -> torch.Tensor:
    """``linear(x)``; with ``tp`` (a mesh axis over which ``linear``'s input
    features are split) the rank's partial product is summed over it in
    float32 and the bias added once, after the sum."""
    if tp is None:
        return linear(x)
    y = tp.all_reduce_sum(F.linear(x, linear.weight))
    if linear.bias is not None:
        y = y + linear.bias.float()
    return y.to(x.dtype)


def frames_gathered(module_forward, x: torch.Tensor, sp, frames_dim: int = 1) -> torch.Tensor:
    """``module_forward(x)`` on every rank's frames of ``x`` (split over the
    mesh axis ``sp`` along ``frames_dim``), keeping this rank's frames of
    the result. Without ``sp``, ``module_forward(x)``."""
    if sp is None:
        return module_forward(x)
    return sp.shard(module_forward(sp.all_gather(x, frames_dim)), frames_dim).contiguous()


class CrossAttention(nn.Module):
    """QKV attention; self-attention when no context is given. Self
    attention keeps the heads packed (B, N, H·D) and goes through
    ``self_attention_packed``; cross-attention with one context row per
    query row folds the heads and goes through ``attention_mh`` (the
    77-token context takes the plain path).

    A context whose batch is smaller than the query batch is shared
    conditioning: one context row per sample while x carries ``b = cb·f``
    frame rows, sample-major. k/v are then projected once per sample and
    the frame axis merges into the query rows (a free reshape), so one
    sample's whole video attends its single context through
    ``cross_attention_packed`` (the VideoCrafter ST block)."""

    def __init__(self, query_dim: int, context_dim: int | None = None,
                 heads: int = 8, dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.dim_head = dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim), nn.Dropout(0.0))

    tp = None  # the mesh axis splitting the heads (parallel/sharding.py)

    def forward(self, x, context=None):
        ctx = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        b, n, inner = q.shape
        if context is None:
            out = self_attention_packed(q, k, v, self.heads)
        elif k.shape[0] != b:
            cb = k.shape[0]
            out = cross_attention_packed(
                q.reshape(cb, (b // cb) * n, inner), k, v, self.heads
            ).reshape(b, n, inner)
        else:
            s = k.shape[1]
            unfold = lambda t, length: t.reshape(b, length, self.heads, self.dim_head)
            out = attention_mh(unfold(q, n), unfold(k, s), unfold(v, s)).reshape(b, n, inner)
        return row_parallel(self.to_out[0], out, self.tp)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class GEGLUFeedForward(nn.Module):
    """GEGLU MLP, exact-erf GELU in the compute dtype; keys ``net.0.proj``
    and ``net.2``."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.Sequential(GEGLU(dim, inner), nn.Dropout(0.0), nn.Linear(inner, dim))

    tp = None  # the mesh axis splitting the hidden width (parallel/sharding.py)

    def forward(self, x):
        return row_parallel(self.net[2], self.net[0](x), self.tp)


class BasicTransformerBlock(nn.Module):
    """Pre-LN self attention, attention over the context (self attention
    again when the context is None), GEGLU feed-forward."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int | None = None):
        super().__init__()
        self.attn1 = CrossAttention(dim, None, heads, dim_head)
        self.ff = GEGLUFeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm1 = LayerNorm32(dim)
        self.norm2 = LayerNorm32(dim)
        self.norm3 = LayerNorm32(dim)

    def forward(self, x, context=None):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context=context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """Attention over the H·W tokens of each frame; input ``(B·F, H, W, C)``;
    linear projections, ``proj_out`` zero-initialised."""

    def __init__(self, channels: int, heads: int, dim_head: int, context_dim: int | None):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, dim_head, context_dim)]
        )
        self.proj_out = nn.Linear(inner, channels)

    def forward(self, x, context=None):
        bf, h, w, c = x.shape
        y = self.proj_in(self.norm(x).reshape(bf, h * w, c))
        for block in self.transformer_blocks:
            y = block(y, context=context)
        return self.proj_out(y).reshape(bf, h, w, c) + x


class TemporalTransformer(nn.Module):
    """Attention over the frame axis; input ``(B, F, H, W, C)``. The tensor
    is transposed once to the ``(B·H·W, F, C)`` token layout and back;
    Conv1d (k=1) projections, ``proj_out`` zero-initialised."""

    def __init__(self, channels: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = nn.Conv1d(channels, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, dim_head, None)]
        )
        self.proj_out = nn.Conv1d(inner, channels, 1)

    sp = None  # the mesh axis splitting the frames (parallel/sharding.py)

    def forward(self, x):
        return frames_gathered(self._forward, x, self.sp)

    def _forward(self, x):
        b, f, h, w, c = x.shape
        y = self.norm(x).permute(0, 2, 3, 1, 4).reshape(b * h * w, f, c)
        y = conv1x1_as_linear(self.proj_in, y)
        for block in self.transformer_blocks:
            y = block(y)
        y = conv1x1_as_linear(self.proj_out, y)
        y = y.reshape(b, h, w, f, c).permute(0, 3, 1, 2, 4)
        return (y + x).contiguous()


class TemporalConvBlock(nn.Module):
    """Four GN+SiLU+Conv3d (3,1,1) layers plus the identity; ``conv4`` is
    zero-initialised. Input ``(B, F, H, W, C)``. Runs as one call of the
    fused chain (``kernels/temporal_conv.py``): the CUDA kernel on the card,
    its plain version on the CPU. Keys ``conv1.{0,2}``, ``conv{2,3,4}.{0,3}``."""

    def __init__(self, channels: int):
        super().__init__()

        def layer(i: int) -> nn.Sequential:
            conv = nn.Conv3d(channels, channels, (3, 1, 1), padding=(1, 0, 0))
            mods = [GroupNorm32(channels), nn.SiLU()]
            if i > 1:
                mods.append(nn.Dropout(0.0))
            return nn.Sequential(*mods, conv)

        self.conv1 = layer(1)
        self.conv2 = layer(2)
        self.conv3 = layer(3)
        self.conv4 = layer(4)

    def chain_layers(self, dtype: torch.dtype):
        """The four (gn_scale, gn_bias, w (3, C_in, C_out), conv_bias)
        tuples of the fused chain's contract."""
        layers = []
        for seq in (self.conv1, self.conv2, self.conv3, self.conv4):
            gn, conv = seq[0], seq[-1]
            w = conv.weight[:, :, :, 0, 0].permute(2, 1, 0).to(dtype).contiguous()
            layers.append((gn.weight, gn.bias, w, conv.bias))
        return layers

    sp = None  # the mesh axis splitting the frames (parallel/sharding.py)

    def forward(self, x):
        return frames_gathered(self._forward, x, self.sp)

    def _forward(self, x):
        b, f, h, w, c = x.shape
        y = temporal_conv_chain(
            x.reshape(b, f, h * w, c), self.chain_layers(x.dtype), eps=self.conv1[0].eps
        )
        return y.reshape(b, f, h, w, c)


class ResBlock(nn.Module):
    """GN+SiLU+Conv, + time embedding, GN+SiLU+zero Conv, 1x1 skip when the
    width changes, then the TemporalConvBlock. Input ``(B·F, H, W, C)``."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 use_temporal_conv: bool = True):
        super().__init__()
        self.in_layers = nn.Sequential(
            GroupNorm32(channels, silu=True), nn.SiLU(),
            Conv2d(channels, out_channels, 3, padding=1),
        )
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_channels, out_channels))
        self.out_layers = nn.Sequential(
            GroupNorm32(out_channels, silu=True), nn.SiLU(), nn.Dropout(0.0),
            Conv2d(out_channels, out_channels, 3, padding=1),
        )
        self.skip_connection = (
            Conv2d(channels, out_channels, 1) if out_channels != channels else None
        )
        self.temopral_conv = TemporalConvBlock(out_channels) if use_temporal_conv else None

    def forward(self, x, emb, frames: int):
        h = self.in_layers[2](self.in_layers[0](x))
        h = h + self.emb_layers[1](F.silu(emb))[:, None, None, :]
        h = self.out_layers[3](self.out_layers[0](h))
        skip = x if self.skip_connection is None else self.skip_connection(x)
        h = skip + h
        if self.temopral_conv is not None:
            bf, hh, ww, cc = h.shape
            h = self.temopral_conv(h.reshape(bf // frames, frames, hh, ww, cc))
            h = h.reshape(bf, hh, ww, cc)
        return h


class Upsample(nn.Module):
    """Nearest 2x + conv3x3. Input ``(B·F, H, W, C)``."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return self.conv(x)


class Downsample(nn.Module):
    """Stride-2 conv3x3. Input ``(B·F, H, W, C)``."""

    def __init__(self, channels: int):
        super().__init__()
        self.op = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)
