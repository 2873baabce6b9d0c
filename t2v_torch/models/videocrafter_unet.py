"""The VideoCrafter (LVDM) 3D UNet in PyTorch.

The port of the JAX package's ``models/videocrafter_unet.py`` (base
text2video config: model_channels 320, channel_mult (1, 2, 4, 4), two
ResBlocks per level, spatial-temporal transformers at downsampling 1, 2
and 4 and in the middle, 8 heads, 768-wide context, ``kernel_size_t`` 1,
relative-position temporal attention over 16 frames).

Layouts and numerics are the JAX package's; module names are the Lightning
checkpoint's ``model.diffusion_model.*`` keys, so ``state_dict()`` goes
through the JAX package's ``convert_vc_unet`` unchanged:

* activations are channels-last ``(B, T, H, W, C)``; with ``kernel_size_t``
  1 every Conv3d is a per-frame 2-D convolution on the ``(B·T, H, W, C)``
  view; GroupNorm statistics span (C/32, T, H, W) of a sample;
* the ST block stays in the spatial token layout ``(B·T, H·W, C)``:
  LayerNorm, the projections and the feed-forward are per token, and only
  the temporal attention cores see the frame axis, through the rel-pos
  kernel's index arithmetic (``kernels/relpos_mha.py``);
* spatial cross-attention takes the un-repeated ``(B, L, D)`` context: k/v
  are projected once per sample and the frames merge into the query rows;
* temporal q/k/v/out, every ``proj_out``, every ResBlock's second conv and
  the head conv are zero-initialised by the JAX package;
* the decoder's skip concat is a plain ``torch.cat``: the JAX package's
  virtual concat pair computes the same function.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from t2v_torch.core.config import VideoCrafterUNetConfig
from t2v_torch.core.profiling import span
from t2v_torch.kernels.attention import relpos_attention
from t2v_torch.models import blocks as B


class Conv3dFactorized(nn.Conv3d):
    """Conv3d (kt, k, k) on channels-last ``(B, T, H, W, C)``; with kt = 1 it
    runs as one 2-D convolution over the ``B·T`` frames."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size_t: int = 1, padding_t: int = 0,
                 spatial_kernel: int = 3, spatial_stride: int = 1, spatial_padding: int = 1):
        super().__init__(
            in_ch, out_ch, (kernel_size_t, spatial_kernel, spatial_kernel),
            stride=(1, spatial_stride, spatial_stride),
            padding=(padding_t, spatial_padding, spatial_padding),
        )

    def forward(self, x):
        b, t, h, w, c = x.shape
        if self.kernel_size[0] == 1:
            y = F.conv2d(x.reshape(b * t, h, w, c).permute(0, 3, 1, 2), self.weight[:, :, 0],
                         self.bias, self.stride[1:], self.padding[1:])
            y = y.permute(0, 2, 3, 1).contiguous()
            return y.reshape(b, t, *y.shape[1:])
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), self.weight, self.bias, self.stride, self.padding)
        return y.permute(0, 2, 3, 4, 1).contiguous()


def _pointwise(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """A Conv3d of kernel (1, 1, 1) applied per token: a Linear over the
    last axis."""
    return F.linear(x, conv.weight[:, :, 0, 0, 0], conv.bias)


class ResBlock3D(nn.Module):
    """GN+SiLU+Conv, + time embedding, GN+SiLU+zero Conv, 1x1x1 skip when the
    width changes. Input ``(B, T, H, W, C)``; a decoder block takes the
    channel concat of the upsampled stream and the skip."""

    def __init__(self, channels: int, out_channels: int, emb_channels: int,
                 kernel_size_t: int = 1, padding_t: int = 0):
        super().__init__()
        self.in_layers = nn.Sequential(
            B.FrameGroupNorm32(channels, silu=True), nn.SiLU(),
            Conv3dFactorized(channels, out_channels, kernel_size_t, padding_t),
        )
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_channels, out_channels))
        self.out_layers = nn.Sequential(
            B.FrameGroupNorm32(out_channels, silu=True), nn.SiLU(), nn.Dropout(0.0),
            Conv3dFactorized(out_channels, out_channels, kernel_size_t, padding_t),
        )
        self.skip_connection = (
            nn.Conv3d(channels, out_channels, 1) if out_channels != channels else None
        )

    def forward(self, x, emb):
        h = self.in_layers[2](self.in_layers[0](x))
        h = h + self.emb_layers[1](F.silu(emb))[:, None, None, None, :]
        h = self.out_layers[3](self.out_layers[0](h))
        skip = x if self.skip_connection is None else _pointwise(self.skip_connection, x)
        return skip + h


class RelativePosition(nn.Module):
    """Learned relative-position table: ``forward(length_q, length_k)`` ->
    (length_q, length_k, num_units), rows picked by the clipped frame
    distance."""

    def __init__(self, num_units: int, max_relative_position: int):
        super().__init__()
        self.max_relative_position = max_relative_position
        self.embeddings_table = nn.Parameter(
            torch.empty(max_relative_position * 2 + 1, num_units))
        nn.init.xavier_uniform_(self.embeddings_table)
        # (length_q, length_k, device) -> row indices, kept on the device: a
        # fresh host array per call would cost a blocking copy at each of the
        # UNet's 64 table reads
        self._rows: dict[tuple, torch.Tensor] = {}

    def forward(self, length_q: int, length_k: int) -> torch.Tensor:
        device = self.embeddings_table.device
        key = (length_q, length_k, device)
        rows = self._rows.get(key)
        if rows is None:
            m = self.max_relative_position
            dist = np.clip(np.arange(length_k)[None, :] - np.arange(length_q)[:, None], -m, m) + m
            rows = self._rows[key] = torch.from_numpy(dist).to(device)
        return self.embeddings_table[rows]


class TemporalCrossAttention(nn.Module):
    """Temporal self-attention with relative-position score and value
    biases; q/k/v/out zero-initialised. Two input contracts:

    * default: ``(B', T, C)`` frame tokens;
    * ``frame_split=t``: ``(B·t, N, C)`` sample-major spatial tokens. The
      per-token projections run in this resident layout and the attention
      core folds the frame axis in its own index arithmetic.

    Both go through ``relpos_attention``, the rel-pos kernel's dispatch (a
    ``(B', T, C)`` input is the resident layout with one spatial token per
    sample); without relative positions the bias tables are zeros."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 temporal_length: int | None = None, use_relative_position: bool = True):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.dim_head = dim_head
        self.use_relative_position = use_relative_position
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(query_dim, inner, bias=False)
        self.to_v = nn.Linear(query_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim), nn.Dropout(0.0))
        if use_relative_position:
            self.relative_position_k = RelativePosition(dim_head, temporal_length)
            self.relative_position_v = RelativePosition(dim_head, temporal_length)

    tp = None  # the mesh axis splitting the heads (parallel/sharding.py)
    sp = None  # the mesh axis splitting the frames

    def forward(self, x, frame_split: int | None = None, mask=None):
        """``mask`` (broadcastable to (T, T), 1 = attend) adds
        (1 - mask)·(-1e9) to the float32 scores; a masked call takes the
        plain version, which the rel-pos kernel's contract does not
        cover. Under ``sp`` x holds this rank's frames: they are gathered,
        every frame attends all T, and this rank's frames come back."""
        if self.sp is None:
            return self._forward(x, frame_split, mask)
        if not frame_split:
            return B.frames_gathered(lambda z: self._forward(z, None, mask), x, self.sp)
        x4 = x.reshape(-1, frame_split, *x.shape[1:])
        y4 = B.frames_gathered(
            lambda z: self._forward(z.flatten(0, 1), z.shape[1], mask).reshape(z.shape),
            x4, self.sp)
        return y4.reshape(x.shape)

    def _forward(self, x, frame_split, mask):
        if self.tp is not None:  # the column-parallel input: its gradient sums over tp
            x = self.tp.copy_in(x)
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        shape = q.shape
        if frame_split:
            t = frame_split
        else:
            b, t, inner = shape
            q, k, v = (z.reshape(b * t, 1, inner) for z in (q, k, v))
        if self.use_relative_position:
            k2 = self.relative_position_k(t, t).to(q.dtype).contiguous()
            v2 = self.relative_position_v(t, t).to(q.dtype).contiguous()
            if self.tp is not None:  # whole tables used by this rank's heads only
                k2, v2 = self.tp.copy_in(k2), self.tp.copy_in(v2)
        else:
            k2 = v2 = q.new_zeros((t, t, self.dim_head))
        out = relpos_attention(q, k, v, k2, v2, self.heads, t, self.dim_head ** -0.5, mask=mask)
        return B.row_parallel(self.to_out[0], out.reshape(shape), self.tp)


class BasicTransformerBlockST(nn.Module):
    """Spatial self -> temporal self -> spatial cross -> temporal self ->
    feed-forward, each pre-LayerNorm with a residual. Input
    ``(B, T, H, W, C)``; the block stays in the ``(B·T, H·W, C)`` token
    layout throughout."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int | None = None,
                 temporal_length: int | None = None, use_relative_position: bool = True):
        super().__init__()
        self.attn1 = B.CrossAttention(dim, None, heads, dim_head)
        self.ff = B.GEGLUFeedForward(dim)
        self.attn2 = B.CrossAttention(dim, context_dim, heads, dim_head)
        self.norm1 = B.LayerNorm32(dim)
        self.norm2 = B.LayerNorm32(dim)
        self.norm3 = B.LayerNorm32(dim)
        self.attn1_tmp = TemporalCrossAttention(dim, heads, dim_head, temporal_length,
                                                use_relative_position)
        self.attn2_tmp = TemporalCrossAttention(dim, heads, dim_head, temporal_length,
                                                use_relative_position)
        self.norm4 = B.LayerNorm32(dim)
        self.norm5 = B.LayerNorm32(dim)

    def forward(self, x, context=None):
        b, t, h, w, c = x.shape
        xs = x.reshape(b * t, h * w, c)
        xs = self.attn1(self.norm1(xs)) + xs
        xs = self.attn1_tmp(self.norm4(xs), frame_split=t) + xs
        xs = self.attn2(self.norm2(xs), context=context) + xs
        xs = self.attn2_tmp(self.norm5(xs), frame_split=t) + xs
        xs = self.ff(self.norm3(xs)) + xs
        return xs.reshape(b, t, h, w, c)


class SpatialTemporalTransformer(nn.Module):
    """GN -> 1x1x1 proj_in -> ST blocks -> zero proj_out + residual. Input
    ``(B, T, H, W, C)``."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int = 1,
                 context_dim: int | None = None, temporal_length: int | None = None,
                 use_relative_position: bool = True):
        super().__init__()
        inner = heads * dim_head
        self.norm = B.FrameGroupNorm32(channels, eps=1e-6)
        self.proj_in = nn.Conv3d(channels, inner, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlockST(inner, heads, dim_head, context_dim, temporal_length,
                                    use_relative_position)
            for _ in range(depth)
        ])
        self.proj_out = nn.Conv3d(inner, channels, 1)

    def forward(self, x, context=None):
        y = _pointwise(self.proj_in, self.norm(x))
        for block in self.transformer_blocks:
            y = block(y, context=context)
        return _pointwise(self.proj_out, y) + x


class _VCDownsample(nn.Module):
    """Stride-2 (1, 3, 3) conv; key ``op``."""

    def __init__(self, channels: int, kernel_size_t: int = 1, padding_t: int = 0):
        super().__init__()
        self.op = Conv3dFactorized(channels, channels, kernel_size_t, padding_t,
                                   spatial_stride=2)

    def forward(self, x):
        return self.op(x)


class _VCUpsample(nn.Module):
    """Nearest 2x over (H, W), then conv; key ``conv``."""

    def __init__(self, channels: int, kernel_size_t: int = 1, padding_t: int = 0):
        super().__init__()
        self.conv = Conv3dFactorized(channels, channels, kernel_size_t, padding_t)

    def forward(self, x):
        return self.conv(x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3))


@dataclass(frozen=True)
class VCBlockDesc:
    kind: str  # conv_in | res | st | downsample | upsample
    flax_name: str
    torch_path: str
    in_ch: int = 0
    out_ch: int = 0


@dataclass(frozen=True)
class VCTopology:
    encoder: tuple[tuple[VCBlockDesc, ...], ...]
    middle: tuple[VCBlockDesc, ...]
    decoder: tuple[tuple[VCBlockDesc, ...], ...]


def build_vc_topology(cfg: VideoCrafterUNetConfig) -> VCTopology:
    mc = cfg.model_channels
    encoder: list[tuple[VCBlockDesc, ...]] = [
        (VCBlockDesc("conv_in", "input_0_0", "input_blocks.0.0", cfg.in_channels, mc),)
    ]
    input_chans = [mc]
    ch = mc
    ds = 1
    idx = 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            entry = [VCBlockDesc("res", f"input_{idx}_0", f"input_blocks.{idx}.0", ch, mult * mc)]
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                entry.append(VCBlockDesc("st", f"input_{idx}_1", f"input_blocks.{idx}.1", ch, ch))
            encoder.append(tuple(entry))
            input_chans.append(ch)
            idx += 1
        if level != len(cfg.channel_mult) - 1:
            encoder.append(
                (VCBlockDesc("downsample", f"input_{idx}_down", f"input_blocks.{idx}.0", ch, ch),))
            input_chans.append(ch)
            ds *= 2
            idx += 1

    middle = (
        VCBlockDesc("res", "middle_0", "middle_block.0", ch, ch),
        VCBlockDesc("st", "middle_1", "middle_block.1", ch, ch),
        VCBlockDesc("res", "middle_2", "middle_block.2", ch, ch),
    )

    decoder: list[tuple[VCBlockDesc, ...]] = []
    idx = 0
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            ich = input_chans.pop()
            entry = [VCBlockDesc("res", f"output_{idx}_0", f"output_blocks.{idx}.0", ch + ich,
                                 mc * mult)]
            ch = mc * mult
            li = 1
            if ds in cfg.attention_resolutions:
                entry.append(VCBlockDesc("st", f"output_{idx}_1", f"output_blocks.{idx}.1", ch, ch))
                li = 2
            if level and i == cfg.num_res_blocks:
                entry.append(VCBlockDesc("upsample", f"output_{idx}_up",
                                         f"output_blocks.{idx}.{li}", ch, ch))
                ds //= 2
            decoder.append(tuple(entry))
            idx += 1
    return VCTopology(tuple(encoder), middle, tuple(decoder))


def count_vc_kernel_sites(cfg: VideoCrafterUNetConfig, frames: int, height: int,
                          width: int, context_len: int = 77) -> dict:
    """Kernel launches of one UNet call with a (B, frames, height, width, C)
    latent and a (B, context_len, D) context: per ST block and depth, two
    rel-pos temporal attentions, one packed cross-attention (a context of
    512 tokens or more folds and goes to flash instead) and one spatial
    self-attention, on flash from 512 tokens and on the packed kernel
    below."""
    from t2v_torch.kernels.attention import FLASH_MIN_KV

    topo = build_vc_topology(cfg)
    counts = {"relpos_mha": 0, "fused_cross_mha": 0, "flash_attention": 0, "fused_self_mha": 0}
    tokens = height * width
    depth = cfg.transformer_depth
    for entry in (*topo.encoder, topo.middle, *topo.decoder):
        for d in entry:
            if d.kind == "st":
                counts["relpos_mha"] += 2 * depth
                counts["fused_cross_mha" if context_len < FLASH_MIN_KV else "flash_attention"] += depth
                counts["flash_attention" if tokens >= FLASH_MIN_KV else "fused_self_mha"] += depth
            elif d.kind == "downsample":
                tokens //= 4
            elif d.kind == "upsample":
                tokens *= 4
    return counts


def _make(d: VCBlockDesc, cfg: VideoCrafterUNetConfig) -> nn.Module:
    kt, pt = cfg.kernel_size_t, cfg.padding_t
    if d.kind == "conv_in":
        return Conv3dFactorized(d.in_ch, d.out_ch, kt, pt)
    if d.kind == "res":
        return ResBlock3D(d.in_ch, d.out_ch, cfg.model_channels * 4, kt, pt)
    if d.kind == "st":
        return SpatialTemporalTransformer(
            d.out_ch, cfg.num_heads, d.out_ch // cfg.num_heads, cfg.transformer_depth,
            cfg.context_dim, cfg.temporal_length, cfg.use_relative_position)
    if d.kind == "downsample":
        return _VCDownsample(d.out_ch, kt, pt)
    if d.kind == "upsample":
        return _VCUpsample(d.out_ch, kt, pt)
    raise ValueError(d.kind)


class FPSEmbedder(nn.Module):
    """``cond_stage2_model``: the clip's frame rate, embedded as the time
    step is (sinusoidal of width ``model_channels``, then Linear, SiLU,
    Linear) into a (B, 4·model_channels) embedding that the UNet adds to
    its time embedding."""

    def __init__(self, model_channels: int):
        super().__init__()
        self.model_channels = model_channels
        emb = model_channels * 4
        self.fps_embed = nn.Sequential(nn.Linear(model_channels, emb), nn.SiLU(),
                                       nn.Linear(emb, emb))

    def forward(self, fps) -> torch.Tensor:
        w = self.fps_embed[0].weight
        fps = torch.as_tensor(fps, dtype=torch.float32, device=w.device).reshape(-1)
        e = B.sinusoidal_embedding(fps, self.model_channels).to(w.dtype)
        return self.fps_embed[2](F.silu(self.fps_embed[0](e)))


class VideoCrafterUNet(nn.Module):
    """forward(x, t, context) -> model output.

    x: (B, T, H, W, in_channels)   latent video, channels-last
    t: (B,)                        timesteps
    context: (B, L, context_dim)   text conditioning, or None
    returns (B, T, H, W, out_channels) in the compute dtype

    ``label_dim``: the width of an embedding-valued ``y`` other than
    4·model_channels, which ``label_proj`` (a Linear) projects first.
    """

    def __init__(self, cfg: VideoCrafterUNetConfig, label_dim: int | None = None):
        super().__init__()
        self.cfg = cfg
        self.topology = build_vc_topology(cfg)
        emb = cfg.model_channels * 4
        self.time_embed = nn.Sequential(
            nn.Linear(cfg.model_channels, emb), nn.SiLU(), nn.Linear(emb, emb))
        if cfg.num_classes is not None:
            self.label_emb = nn.Embedding(cfg.num_classes, emb)
        self.label_proj = (nn.Linear(label_dim, emb)
                           if label_dim is not None and label_dim != emb else None)
        topo = self.topology
        self.input_blocks = nn.ModuleList(
            [nn.ModuleList([_make(d, cfg) for d in entry]) for entry in topo.encoder])
        self.middle_block = nn.ModuleList([_make(d, cfg) for d in topo.middle])
        self.output_blocks = nn.ModuleList(
            [nn.ModuleList([_make(d, cfg) for d in entry]) for entry in topo.decoder])
        self.out = nn.Sequential(
            B.FrameGroupNorm32(cfg.model_channels, silu=True), nn.SiLU(),
            Conv3dFactorized(cfg.model_channels, cfg.out_channels, cfg.kernel_size_t,
                             cfg.padding_t),
        )

    def _run_block(self, d: VCBlockDesc, x, emb, ctx):
        mod = self.get_submodule(d.torch_path)
        with span("t2v.unet." + d.kind):
            if d.kind == "res":
                return mod(x, emb)
            if d.kind == "st":
                return mod(x, context=ctx)
            return mod(x)

    def forward(self, x, t, context, features_adapter=None, y=None, time_emb_replace=None,
                temporal_context=None):
        """features_adapter: per-scale feature maps (B, [T,] h, w, c) added
        after every third input block. y: class labels (B,) int, or an
        embedding (B, 4*model_channels) that is added to the time embedding.
        time_emb_replace: a precomputed (B, 4*model_channels) embedding that
        replaces the timestep embedding. temporal_context: FPS embedding
        (B|1, 4*model_channels), added to the time embedding."""
        with span("t2v.unet"):
            cfg = self.cfg
            dtype = self.out[2].weight.dtype
            if time_emb_replace is None:
                e = B.sinusoidal_embedding(t, cfg.model_channels).to(dtype)
                emb = self.time_embed[2](F.silu(self.time_embed[0](e)))
            else:
                emb = time_emb_replace.to(dtype)
            if y is not None:
                if cfg.num_classes is not None and not torch.is_floating_point(y):
                    lab = self.label_emb(y)
                elif y.shape[-1] == cfg.model_channels * 4:
                    lab = y
                elif self.label_proj is not None and y.shape[-1] == self.label_proj.in_features:
                    lab = self.label_proj(y.to(dtype))
                else:
                    raise ValueError(
                        f"y of width {y.shape[-1]}: this UNet takes a (B,) label, or an embedding "
                        f"of width {cfg.model_channels * 4}"
                        + (f" or {self.label_proj.in_features}" if self.label_proj else ""))
                emb = emb + lab.to(emb.dtype)
            if temporal_context is not None:
                emb = emb + temporal_context.to(emb.dtype)

            x = x.to(dtype)
            ctx = None if context is None else context.to(dtype)
            topo = self.topology
            hs = []
            adapter_idx = 0
            for eid, entry in enumerate(topo.encoder):
                for d in entry:
                    x = self._run_block(d, x, emb, ctx)
                if (features_adapter is not None and (eid + 1) % 3 == 0
                        and adapter_idx < len(features_adapter)):
                    feat = features_adapter[adapter_idx].to(x.dtype)
                    if feat.dim() == 4:  # (B, h, w, c): the same map for every frame
                        feat = feat[:, None]
                    x = x + feat
                    adapter_idx += 1
                hs.append(x)
            for d in topo.middle:
                x = self._run_block(d, x, emb, ctx)
            for entry in topo.decoder:
                x = torch.cat([x, hs.pop()], dim=-1)
                for d in entry:
                    x = self._run_block(d, x, emb, ctx)
            return self.out[2](self.out[0](x))
