"""Plain float32 reference of the ModelScope text-to-video UNet (UNetSD).

Written from the published architecture (damo-vilab
modelscope-damo-text-to-video-synthesis, ``UNetSD``): 3D-factorised
ResBlocks, each followed by a temporal convolution block of four
GroupNorm+SiLU+Conv3d(3,1,1) layers; spatial transformers with cross
attention to the text; temporal transformers attending over the frames;
the encoder / middle / decoder layout of ``dim_mult`` with skip concats.
Latents are channels-last (B, F, H, W, C). Parameter names are the published
state dict's. The configuration is a dict of the fields of the benchmark's
config file (``unet``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import layers as L
from benchmark.reference.ops import Ops


def _entries(cfg: dict):
    """The (encoder, middle, decoder) lists of (kind, path, in_ch, out_ch,
    heads) in the published module order."""
    dim, mult = cfg["dim"], list(cfg["dim_mult"])
    enc_dims = [dim * u for u in [1, *mult]]
    dec_dims = [dim * u for u in [mult[-1], *mult[::-1]]]
    temporal = cfg["temporal_attention"]
    scales = [float(s) for s in cfg["attn_scales"]]
    skips, scale = [dim], 1.0
    enc = [[("conv_in", "input_blocks.0.0", cfg["in_dim"], dim, 0)]]
    if temporal:
        enc[0].append(("temporal", "input_blocks.0.1", dim, dim, cfg["num_heads"]))
    idx = 1
    for i, (din, dout) in enumerate(zip(enc_dims[:-1], enc_dims[1:])):
        for j in range(cfg["num_res_blocks"]):
            e = [("res", f"input_blocks.{idx}.0", din, dout, 0)]
            if scale in scales:
                e.append(("spatial", f"input_blocks.{idx}.1", dout, dout, 0))
                if temporal:
                    e.append(("temporal", f"input_blocks.{idx}.2", dout, dout, 0))
            enc.append(e)
            skips.append(dout)
            din = dout
            idx += 1
            if i != len(mult) - 1 and j == cfg["num_res_blocks"] - 1:
                enc.append([("down", f"input_blocks.{idx}", dout, dout, 0)])
                skips.append(dout)
                scale /= 2.0
                idx += 1
    c = enc_dims[-1]
    mid = [("res", "middle_block.0", c, c, 0), ("spatial", "middle_block.1", c, c, 0)]
    if temporal:
        mid.append(("temporal", "middle_block.2", c, c, 0))
    mid.append(("res", f"middle_block.{len(mid)}", c, c, 0))
    dec = []
    idx = 0
    for i, (din, dout) in enumerate(zip(dec_dims[:-1], dec_dims[1:])):
        for j in range(cfg["num_res_blocks"] + 1):
            e = [("res", f"output_blocks.{idx}.0", din + skips.pop(), dout, 0)]
            if scale in scales:
                e.append(("spatial", f"output_blocks.{idx}.1", dout, dout, 0))
                if temporal:
                    e.append(("temporal", f"output_blocks.{idx}.2", dout, dout, 0))
            din = dout
            if i != len(mult) - 1 and j == cfg["num_res_blocks"]:
                e.append(("up", f"output_blocks.{idx}.{len(e)}", dout, dout, 0))
                scale *= 2.0
            dec.append(e)
            idx += 1
    return enc, mid, dec


def _heads(cfg, out_ch, heads):
    """The heads of a transformer: its own count, else one per head_dim channels."""
    return heads or out_ch // cfg["head_dim"]


def _block_shapes(cfg: dict, kind: str, p: str, cin: int, cout: int, heads: int):
    emb = cfg["dim"] * 4
    if kind == "conv_in":
        return L.conv_shapes(p, cin, cout, (3, 3))
    if kind == "res":
        out = [*L.norm_shapes(f"{p}.in_layers.0", cin), *L.conv_shapes(f"{p}.in_layers.2", cin, cout, (3, 3)),
               *L.linear_shapes(f"{p}.emb_layers.1", emb, cout),
               *L.norm_shapes(f"{p}.out_layers.0", cout), *L.conv_shapes(f"{p}.out_layers.3", cout, cout, (3, 3))]
        if cin != cout:
            out += L.conv_shapes(f"{p}.skip_connection", cin, cout, (1, 1))
        for i, slot in ((1, 2), (2, 3), (3, 3), (4, 3)):
            out += [*L.norm_shapes(f"{p}.temopral_conv.conv{i}.0", cout),
                    *L.conv_shapes(f"{p}.temopral_conv.conv{i}.{slot}", cout, cout, (3, 1, 1))]
        return out
    if kind in ("spatial", "temporal"):
        dh = cfg["head_dim"]
        h = _heads(cfg, cout, heads)
        inner = h * dh
        ctx = cfg["context_dim"] if kind == "spatial" else None
        k = () if kind == "spatial" else (1,)
        proj = (lambda q, a, b: L.linear_shapes(q, a, b)) if kind == "spatial" else (
            lambda q, a, b: L.conv_shapes(q, a, b, k))
        return [*L.norm_shapes(f"{p}.norm", cout), *proj(f"{p}.proj_in", cout, inner),
                *L.transformer_block_shapes(f"{p}.transformer_blocks.0", inner, ctx, h, dh),
                *proj(f"{p}.proj_out", inner, cout)]
    if kind == "down":
        return L.conv_shapes(f"{p}.op", cout, cout, (3, 3))
    if kind == "up":
        return L.conv_shapes(f"{p}.conv", cout, cout, (3, 3))
    raise ValueError(kind)


def param_shapes(cfg: dict):
    """(name, shape) of every parameter of the UNet."""
    emb = cfg["dim"] * 4
    out = [*L.linear_shapes("time_embed.0", cfg["dim"], emb), *L.linear_shapes("time_embed.2", emb, emb)]
    enc, mid, dec = _entries(cfg)
    for entry in (*enc, mid, *dec):
        for d in entry:
            out += _block_shapes(cfg, *d)
    out += [*L.norm_shapes("out.0", cfg["dim"]), *L.conv_shapes("out.2", cfg["dim"], cfg["out_dim"], (3, 3))]
    return out


def _temporal_conv(ops: Ops, sd, p: str, x):
    """Identity plus four GroupNorm(32, eps 1e-5)+SiLU+Conv3d (3,1,1) layers
    over (B, F, H, W, C); the statistics of each norm span the frames."""
    h = x
    for i, slot in ((1, 2), (2, 3), (3, 3), (4, 3)):
        h = L.gn(sd, f"{p}.conv{i}.0", h, 1e-5, silu=True)
        h = ops.conv3d(h, sd[f"{p}.conv{i}.{slot}.weight"], sd[f"{p}.conv{i}.{slot}.bias"],
                       padding=(1, 0, 0))
    return x + h


def _res(ops, sd, p, x, emb, frames):
    """x (B·F, H, W, C), emb (B·F, E)."""
    h = L.conv2d(ops, sd, f"{p}.in_layers.2", L.gn(sd, f"{p}.in_layers.0", x, 1e-5, True), padding=1)
    h = h + L.lin(ops, sd, f"{p}.emb_layers.1", F.silu(emb))[:, None, None, :]
    h = L.conv2d(ops, sd, f"{p}.out_layers.3", L.gn(sd, f"{p}.out_layers.0", h, 1e-5, True), padding=1)
    skip = x if f"{p}.skip_connection.weight" not in sd else L.conv2d(ops, sd, f"{p}.skip_connection", x)
    h = skip + h
    bf, hh, ww, c = h.shape
    h = _temporal_conv(ops, sd, f"{p}.temopral_conv", h.reshape(bf // frames, frames, hh, ww, c))
    return h.reshape(bf, hh, ww, c)


def _spatial(ops, sd, p, x, ctx, heads):
    bf, h, w, c = x.shape
    y = L.lin(ops, sd, f"{p}.proj_in", L.gn(sd, f"{p}.norm", x, 1e-6).reshape(bf, h * w, c))
    y = L.transformer_block(ops, sd, f"{p}.transformer_blocks.0", y, heads, ctx)
    return L.lin(ops, sd, f"{p}.proj_out", y).reshape(bf, h, w, c) + x


def _temporal(ops, sd, p, x, heads, frames):
    bf, h, w, c = x.shape
    b = bf // frames
    y = L.gn(sd, f"{p}.norm", x.reshape(b, frames, h, w, c), 1e-6)
    y = y.permute(0, 2, 3, 1, 4).reshape(b * h * w, frames, c)
    pw = lambda q, t: ops.linear(t, sd[f"{q}.weight"][:, :, 0], sd[f"{q}.bias"])
    y = pw(f"{p}.proj_in", y)
    y = L.transformer_block(ops, sd, f"{p}.transformer_blocks.0", y, heads)
    y = pw(f"{p}.proj_out", y)
    y = y.reshape(b, h, w, frames, c).permute(0, 3, 1, 2, 4).reshape(bf, h, w, c)
    return y + x


def forward(sd, cfg: dict, x, t, context, ops: Ops | None = None):
    """x (B, F, H, W, in_dim), t (B,), context (B, L, context_dim) ->
    (B, F, H, W, out_dim), float32."""
    ops = ops or Ops()
    b, f, hh, ww, _ = x.shape
    e = L.timestep_embedding(t, cfg["dim"])
    e = L.lin(ops, sd, "time_embed.2", F.silu(L.lin(ops, sd, "time_embed.0", e)))
    e = e.repeat_interleave(f, dim=0)
    ctx = context.float().repeat_interleave(f, dim=0)
    h = x.float().reshape(b * f, hh, ww, x.shape[-1])

    def block(kind, p, cin, cout, heads, h):
        if kind == "conv_in":
            return L.conv2d(ops, sd, p, h, padding=1)
        if kind == "res":
            return _res(ops, sd, p, h, e, f)
        if kind == "spatial":
            return _spatial(ops, sd, p, h, ctx, _heads(cfg, cout, heads))
        if kind == "temporal":
            return _temporal(ops, sd, p, h, _heads(cfg, cout, heads), f)
        if kind == "down":
            return L.conv2d(ops, sd, f"{p}.op", h, stride=2, padding=1)
        return L.conv2d(ops, sd, f"{p}.conv", L.upsample_nearest(h), padding=1)

    enc, mid, dec = _entries(cfg)
    skips = []
    for entry in enc:
        for d in entry:
            h = block(*d, h)
        skips.append(h)
    for d in mid:
        h = block(*d, h)
    for entry in dec:
        h = torch.cat([h, skips.pop()], dim=-1)
        for d in entry:
            h = block(*d, h)
    h = L.conv2d(ops, sd, "out.2", L.gn(sd, "out.0", h, 1e-5, True), padding=1)
    return h.reshape(b, f, hh, ww, cfg["out_dim"])
