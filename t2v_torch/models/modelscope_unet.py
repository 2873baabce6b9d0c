"""UNetSD — the 3D-factorised UNet (1.41B parameters at the default config)
of the ModelScope 1.7B text2video model, in PyTorch.

The port of the JAX package's ``models/modelscope_unet.py``. The topology
is built once as a list of descriptors (``build_topology``, the port's own
copy) that both the module and the converter (``io/convert.py``) read;
sub-modules sit at their reference state-dict paths (``input_blocks.1.0``,
``middle_block.2``, ``output_blocks.5.2`` …), so ``state_dict()`` keys are
the reference checkpoint's.

Layer order per encoder stage: init Conv2d + TemporalTransformer; per
scale, ResBlock [+ SpatialTransformer + TemporalTransformer when the scale
is in ``attn_scales``]; Downsample after the last block of every scale but
the last. Middle: Res + Spatial + Temporal + Res. The decoder mirrors it
with the skip concat and Upsample. Head: GN + SiLU + zero Conv.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from t2v_torch.core.config import ModelScopeUNetConfig
from t2v_torch.models import blocks as B


@dataclass(frozen=True)
class BlockDesc:
    """One sub-module of the UNet graph.

    kind: conv_in | res | spatial | temporal | downsample | upsample
    flax_name: the JAX package's parameter-tree name of the sub-module
    torch_path: the reference state-dict prefix (e.g. "input_blocks.1.0")
    """

    kind: str
    flax_name: str
    torch_path: str
    in_ch: int = 0
    out_ch: int = 0
    heads: int = 0


@dataclass(frozen=True)
class Topology:
    encoder: tuple[tuple[BlockDesc, ...], ...]  # per input_blocks entry
    middle: tuple[BlockDesc, ...]
    decoder: tuple[tuple[BlockDesc, ...], ...]  # per output_blocks entry


def build_topology(cfg: ModelScopeUNetConfig) -> Topology:
    enc_dims = [cfg.dim * u for u in (1, *cfg.dim_mult)]
    dec_dims = [cfg.dim * u for u in (cfg.dim_mult[-1], *cfg.dim_mult[::-1])]
    shortcut_dims: list[int] = []
    scale = 1.0

    encoder: list[tuple[BlockDesc, ...]] = []
    init = [BlockDesc("conv_in", "input_0_0", "input_blocks.0.0", cfg.in_dim, cfg.dim)]
    if cfg.temporal_attention:
        init.append(BlockDesc("temporal", "input_0_1", "input_blocks.0.1", cfg.dim, cfg.dim,
                              heads=cfg.num_heads))
    encoder.append(tuple(init))
    shortcut_dims.append(cfg.dim)

    idx = 1
    for i, (din, dout) in enumerate(zip(enc_dims[:-1], enc_dims[1:])):
        for j in range(cfg.num_res_blocks):
            entry = [BlockDesc("res", f"input_{idx}_0", f"input_blocks.{idx}.0", din, dout)]
            if scale in cfg.attn_scales:
                entry.append(BlockDesc("spatial", f"input_{idx}_1", f"input_blocks.{idx}.1",
                                       dout, dout))
                if cfg.temporal_attention:
                    entry.append(BlockDesc("temporal", f"input_{idx}_2",
                                           f"input_blocks.{idx}.2", dout, dout))
            encoder.append(tuple(entry))
            shortcut_dims.append(dout)
            din = dout
            idx += 1
            if i != len(cfg.dim_mult) - 1 and j == cfg.num_res_blocks - 1:
                encoder.append((BlockDesc("downsample", f"input_{idx}_down",
                                          f"input_blocks.{idx}", dout, dout),))
                shortcut_dims.append(dout)
                scale /= 2.0
                idx += 1

    out_ch = enc_dims[-1]
    middle = [
        BlockDesc("res", "middle_0", "middle_block.0", out_ch, out_ch),
        BlockDesc("spatial", "middle_1", "middle_block.1", out_ch, out_ch),
    ]
    mi = 2
    if cfg.temporal_attention:
        middle.append(BlockDesc("temporal", "middle_2", f"middle_block.{mi}", out_ch, out_ch))
        mi += 1
    middle.append(BlockDesc("res", f"middle_{mi}", f"middle_block.{mi}", out_ch, out_ch))

    decoder: list[tuple[BlockDesc, ...]] = []
    idx = 0
    for i, (din, dout) in enumerate(zip(dec_dims[:-1], dec_dims[1:])):
        for j in range(cfg.num_res_blocks + 1):
            skip = shortcut_dims.pop()
            entry = [BlockDesc("res", f"output_{idx}_0", f"output_blocks.{idx}.0",
                               din + skip, dout)]
            ti = 1
            if scale in cfg.attn_scales:
                entry.append(BlockDesc("spatial", f"output_{idx}_1", f"output_blocks.{idx}.1",
                                       dout, dout))
                ti = 2
                if cfg.temporal_attention:
                    entry.append(BlockDesc("temporal", f"output_{idx}_2",
                                           f"output_blocks.{idx}.2", dout, dout))
                    ti = 3
            din = dout
            if i != len(cfg.dim_mult) - 1 and j == cfg.num_res_blocks:
                entry.append(BlockDesc("upsample", f"output_{idx}_up",
                                       f"output_blocks.{idx}.{ti}", dout, dout))
                scale *= 2.0
            decoder.append(tuple(entry))
            idx += 1

    return Topology(tuple(encoder), tuple(middle), tuple(decoder))


def _make(d: BlockDesc, cfg: ModelScopeUNetConfig) -> nn.Module:
    if d.kind == "conv_in":
        return B.Conv2d(d.in_ch, d.out_ch, 3, padding=1)
    if d.kind == "res":
        return B.ResBlock(d.in_ch, cfg.embed_dim, d.out_ch)
    if d.kind == "spatial":
        return B.SpatialTransformer(d.out_ch, d.out_ch // cfg.head_dim, cfg.head_dim,
                                    cfg.context_dim)
    if d.kind == "temporal":
        heads = d.heads or d.out_ch // cfg.head_dim
        return B.TemporalTransformer(d.out_ch, heads, cfg.head_dim)
    if d.kind == "downsample":
        return B.Downsample(d.out_ch)
    if d.kind == "upsample":
        return B.Upsample(d.out_ch)
    raise ValueError(d.kind)


def count_kernel_sites(cfg: ModelScopeUNetConfig, frames: int, height: int, width: int) -> dict:
    """Kernel launches of one UNet call with a (B, frames, height, width, C)
    latent at full self-attention: TemporalConvBlocks x 4 layers, spatial
    self-attention with >= 512 tokens on the flash kernel, the rest of the
    self-attention (spatial below 512 tokens, both self-attentions of every
    temporal transformer) on the packed short-sequence kernel."""
    from t2v_torch.kernels.attention import FLASH_MIN_KV

    topo = build_topology(cfg)
    counts = {"temporal_conv": 0, "flash_attention": 0, "fused_self_mha": 0}
    tokens = height * width
    for entry in (*topo.encoder, topo.middle, *topo.decoder):
        for d in entry:
            if d.kind == "res":
                counts["temporal_conv"] += 4
            elif d.kind == "spatial":
                key = "flash_attention" if tokens >= FLASH_MIN_KV else "fused_self_mha"
                counts[key] += 1
            elif d.kind == "temporal":
                counts["fused_self_mha" if frames < FLASH_MIN_KV else "flash_attention"] += 2
            elif d.kind == "downsample":
                tokens //= 4
            elif d.kind == "upsample":
                tokens *= 4
    return counts


class UNetSD(nn.Module):
    """forward(x, t, context) -> eps prediction.

    x: (B, F, H, W, in_dim)     latent video, channels-last
    t: (B,)                     timesteps
    context: (B, L, context_dim) text conditioning
    returns (B, F, H, W, out_dim) in the compute dtype
    """

    def __init__(self, cfg: ModelScopeUNetConfig):
        super().__init__()
        self.cfg = cfg
        self.topology = build_topology(cfg)
        self.time_embed = nn.Sequential(
            nn.Linear(cfg.dim, cfg.embed_dim), nn.SiLU(), nn.Linear(cfg.embed_dim, cfg.embed_dim)
        )
        topo = self.topology
        self.input_blocks = nn.ModuleList()
        for entry in topo.encoder:
            if entry[0].kind == "downsample":
                self.input_blocks.append(_make(entry[0], cfg))
            else:
                self.input_blocks.append(nn.ModuleList([_make(d, cfg) for d in entry]))
        self.middle_block = nn.ModuleList([_make(d, cfg) for d in topo.middle])
        self.output_blocks = nn.ModuleList(
            [nn.ModuleList([_make(d, cfg) for d in entry]) for entry in topo.decoder]
        )
        self.out = nn.Sequential(
            B.GroupNorm32(cfg.dim, silu=True), nn.SiLU(), B.Conv2d(cfg.dim, cfg.out_dim, 3, padding=1)
        )

    def _run_block(self, d: BlockDesc, x, e, ctx, b: int, f: int):
        mod = self.get_submodule(d.torch_path)
        if d.kind in ("conv_in", "downsample", "upsample"):
            return mod(x)
        if d.kind == "res":
            return mod(x, e, f)
        if d.kind == "spatial":
            return mod(x, context=ctx)
        bf, h, w, c = x.shape
        return mod(x.reshape(b, f, h, w, c)).reshape(bf, h, w, c)

    def forward(self, x, t, context):
        b, f, h, w, _ = x.shape
        dtype = self.out[2].weight.dtype
        e = B.sinusoidal_embedding(t, self.cfg.dim).to(dtype)
        e = self.time_embed[2](F.silu(self.time_embed[0](e)))
        # per-frame repeat in torch repeat_interleave order
        e_f = e.repeat_interleave(f, dim=0)
        ctx_f = context.to(dtype).repeat_interleave(f, dim=0)
        x = x.to(dtype).reshape(b * f, h, w, x.shape[-1])

        topo = self.topology
        xs = []
        for entry in topo.encoder:
            for d in entry:
                x = self._run_block(d, x, e_f, ctx_f, b, f)
            xs.append(x)
        for d in topo.middle:
            x = self._run_block(d, x, e_f, ctx_f, b, f)
        for entry in topo.decoder:
            x = torch.cat([x, xs.pop()], dim=-1)
            for d in entry:
                x = self._run_block(d, x, e_f, ctx_f, b, f)

        x = self.out[2](self.out[0](x))
        return x.reshape(b, f, h, w, self.cfg.out_dim)
