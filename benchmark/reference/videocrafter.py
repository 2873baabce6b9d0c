"""Plain float32 reference of the VideoCrafter (LVDM) text-to-video UNet.

Written from the published architecture (VideoCrafter ``base_t2v``
``model_config.yaml``, LVDM ``UNetModel``): ResBlocks with (1, 3, 3)
convolutions whose GroupNorm statistics span the frames, spatial-temporal
transformers (spatial self attention, temporal self attention with learned
relative-position key and value tables, spatial cross attention to the
text, temporal self attention again, GEGLU feed-forward), the encoder /
middle / decoder layout of ``channel_mult`` with skip concats. Latents are
channels-last (B, T, H, W, C); parameter names are the published state
dict's. The configuration is the ``unet`` dict of the benchmark's config
file.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import layers as L
from benchmark.reference.ops import Ops


def _entries(cfg: dict):
    mc, mult = cfg["model_channels"], list(cfg["channel_mult"])
    attn = list(cfg["attention_resolutions"])
    enc = [[("conv_in", "input_blocks.0.0", cfg["in_channels"], mc)]]
    chans, ch, ds, idx = [mc], mc, 1, 1
    for level, m in enumerate(mult):
        for _ in range(cfg["num_res_blocks"]):
            e = [("res", f"input_blocks.{idx}.0", ch, m * mc)]
            ch = m * mc
            if ds in attn:
                e.append(("st", f"input_blocks.{idx}.1", ch, ch))
            enc.append(e)
            chans.append(ch)
            idx += 1
        if level != len(mult) - 1:
            enc.append([("down", f"input_blocks.{idx}.0", ch, ch)])
            chans.append(ch)
            ds *= 2
            idx += 1
    mid = [("res", "middle_block.0", ch, ch), ("st", "middle_block.1", ch, ch),
           ("res", "middle_block.2", ch, ch)]
    dec, idx = [], 0
    for level, m in list(enumerate(mult))[::-1]:
        for i in range(cfg["num_res_blocks"] + 1):
            e = [("res", f"output_blocks.{idx}.0", ch + chans.pop(), mc * m)]
            ch = mc * m
            if ds in attn:
                e.append(("st", f"output_blocks.{idx}.1", ch, ch))
            if level and i == cfg["num_res_blocks"]:
                e.append(("up", f"output_blocks.{idx}.{len(e)}", ch, ch))
                ds //= 2
            dec.append(e)
            idx += 1
    return enc, mid, dec


def _conv_k(cfg):
    return (cfg["kernel_size_t"], 3, 3)


def _temporal_attn_shapes(p, dim, heads, dh, cfg):
    out = L.attention_shapes(p, dim, None, heads * dh)
    if cfg["use_relative_position"]:
        rows = 2 * cfg["temporal_length"] + 1
        out += [(f"{p}.relative_position_k.embeddings_table", (rows, dh)),
                (f"{p}.relative_position_v.embeddings_table", (rows, dh))]
    return out


def _block_shapes(cfg, kind, p, cin, cout):
    emb = cfg["model_channels"] * 4
    if kind == "conv_in":
        return L.conv_shapes(p, cin, cout, _conv_k(cfg))
    if kind == "res":
        out = [*L.norm_shapes(f"{p}.in_layers.0", cin), *L.conv_shapes(f"{p}.in_layers.2", cin, cout, _conv_k(cfg)),
               *L.linear_shapes(f"{p}.emb_layers.1", emb, cout),
               *L.norm_shapes(f"{p}.out_layers.0", cout),
               *L.conv_shapes(f"{p}.out_layers.3", cout, cout, _conv_k(cfg))]
        if cin != cout:
            out += L.conv_shapes(f"{p}.skip_connection", cin, cout, (1, 1, 1))
        return out
    if kind == "st":
        heads = cfg["num_heads"]
        dh = cout // heads
        inner = heads * dh
        out = [*L.norm_shapes(f"{p}.norm", cout), *L.conv_shapes(f"{p}.proj_in", cout, inner, (1, 1, 1))]
        for d in range(cfg["transformer_depth"]):
            q = f"{p}.transformer_blocks.{d}"
            out += L.transformer_block_shapes(q, inner, cfg["context_dim"], heads, dh)
            out += _temporal_attn_shapes(f"{q}.attn1_tmp", inner, heads, dh, cfg)
            out += _temporal_attn_shapes(f"{q}.attn2_tmp", inner, heads, dh, cfg)
            out += [*L.norm_shapes(f"{q}.norm4", inner), *L.norm_shapes(f"{q}.norm5", inner)]
        return out + L.conv_shapes(f"{p}.proj_out", inner, cout, (1, 1, 1))
    if kind == "down":
        return L.conv_shapes(f"{p}.op", cout, cout, _conv_k(cfg))
    if kind == "up":
        return L.conv_shapes(f"{p}.conv", cout, cout, _conv_k(cfg))
    raise ValueError(kind)


def param_shapes(cfg: dict):
    mc = cfg["model_channels"]
    emb = mc * 4
    out = [*L.linear_shapes("time_embed.0", mc, emb), *L.linear_shapes("time_embed.2", emb, emb)]
    enc, mid, dec = _entries(cfg)
    for entry in (*enc, mid, *dec):
        for d in entry:
            out += _block_shapes(cfg, *d)
    return out + [*L.norm_shapes("out.0", mc),
                  *L.conv_shapes("out.2", mc, cfg["out_channels"], _conv_k(cfg))]


def _conv(ops, sd, p, x, stride=1, cfg=None):
    """(kt, 3, 3) convolution over (B, T, H, W, C), spatial padding 1."""
    w = sd[f"{p}.weight"]
    pad = (cfg["padding_t"], 1, 1)
    return ops.conv3d(x, w, sd[f"{p}.bias"], (1, stride, stride), pad)


def _pointwise(ops, sd, p, x):
    return ops.linear(x, sd[f"{p}.weight"][:, :, 0, 0, 0], sd[f"{p}.bias"])


def _res(ops, sd, p, x, emb, cfg):
    h = _conv(ops, sd, f"{p}.in_layers.2", L.gn(sd, f"{p}.in_layers.0", x, 1e-5, True), cfg=cfg)
    h = h + L.lin(ops, sd, f"{p}.emb_layers.1", F.silu(emb))[:, None, None, None, :]
    h = _conv(ops, sd, f"{p}.out_layers.3", L.gn(sd, f"{p}.out_layers.0", h, 1e-5, True), cfg=cfg)
    skip = x if f"{p}.skip_connection.weight" not in sd else _pointwise(ops, sd, f"{p}.skip_connection", x)
    return skip + h


def _rel_tables(sd, p, t, m):
    """(T, T, dh) key and value tables: row clip(j - i, -m, m) + m."""
    dist = np.clip(np.arange(t)[None, :] - np.arange(t)[:, None], -m, m) + m
    rows = torch.from_numpy(dist).to(sd[f"{p}.relative_position_k.embeddings_table"].device)
    return (sd[f"{p}.relative_position_k.embeddings_table"].float()[rows],
            sd[f"{p}.relative_position_v.embeddings_table"].float()[rows])


def _temporal_attn(ops, sd, p, x, heads, t, cfg):
    """x (B·T, N, C) sample-major: every spatial token attends over the T
    frames of its sample."""
    bt, n, c = x.shape
    b = bt // t
    y = x.reshape(b, t, n, c).transpose(1, 2).reshape(b * n, t, c)
    if cfg["use_relative_position"]:
        rel = _rel_tables(sd, p, t, cfg["temporal_length"])
    else:
        dh = c // heads
        rel = (torch.zeros(t, t, dh, device=x.device),) * 2
    y = L.attention(ops, sd, p, y, heads, rel=rel)
    return y.reshape(b, n, t, -1).transpose(1, 2).reshape(bt, n, -1)


def _st(ops, sd, p, x, ctx, cfg):
    b, t, h, w, c = x.shape
    heads = cfg["num_heads"]
    y = _pointwise(ops, sd, f"{p}.proj_in", L.gn(sd, f"{p}.norm", x, 1e-6))
    inner = y.shape[-1]
    xs = y.reshape(b * t, h * w, inner)
    for d in range(cfg["transformer_depth"]):
        q = f"{p}.transformer_blocks.{d}"
        xs = L.attention(ops, sd, f"{q}.attn1", L.ln(sd, f"{q}.norm1", xs), heads) + xs
        xs = _temporal_attn(ops, sd, f"{q}.attn1_tmp", L.ln(sd, f"{q}.norm4", xs), heads, t, cfg) + xs
        xs = L.attention(ops, sd, f"{q}.attn2", L.ln(sd, f"{q}.norm2", xs), heads, ctx) + xs
        xs = _temporal_attn(ops, sd, f"{q}.attn2_tmp", L.ln(sd, f"{q}.norm5", xs), heads, t, cfg) + xs
        xs = L.geglu(ops, sd, f"{q}.ff", L.ln(sd, f"{q}.norm3", xs)) + xs
    y = xs.reshape(b, t, h, w, inner)
    return _pointwise(ops, sd, f"{p}.proj_out", y) + x


def forward(sd, cfg: dict, x, t, context, ops: Ops | None = None):
    """x (B, T, H, W, in_channels), t (B,), context (B, L, context_dim) ->
    (B, T, H, W, out_channels), float32."""
    ops = ops or Ops()
    e = L.timestep_embedding(t, cfg["model_channels"])
    emb = L.lin(ops, sd, "time_embed.2", F.silu(L.lin(ops, sd, "time_embed.0", e)))
    ctx = context.float()
    h = x.float()

    def block(kind, p, cin, cout, h):
        if kind == "res":
            return _res(ops, sd, p, h, emb, cfg)
        if kind == "st":
            return _st(ops, sd, p, h, ctx, cfg)
        if kind == "conv_in":
            return _conv(ops, sd, p, h, cfg=cfg)
        if kind == "down":
            return _conv(ops, sd, f"{p}.op", h, 2, cfg)
        return _conv(ops, sd, f"{p}.conv", L.upsample_nearest(h, (2, 3)), cfg=cfg)

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
    return _conv(ops, sd, "out.2", L.gn(sd, "out.0", h, 1e-5, True), cfg=cfg)
