"""Plain float32 layers shared by the reference UNets, VAE and text towers.

Functions over a flat state dict ``sd`` (parameter name -> tensor) and a
module path ``p``; the names are the published checkpoints' and so the
port's. Every ``*_shapes`` function lists the (name, shape) of the
parameters its forward reads, which is how the benchmark draws one set of
weights for the program and for the reference.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.ops import Ops, group_norm, layer_norm


def linear_shapes(p: str, d_in: int, d_out: int, bias: bool = True):
    out = [(f"{p}.weight", (d_out, d_in))]
    return out + ([(f"{p}.bias", (d_out,))] if bias else [])


def norm_shapes(p: str, c: int):
    return [(f"{p}.weight", (c,)), (f"{p}.bias", (c,))]


def conv_shapes(p: str, c_in: int, c_out: int, kernel: tuple[int, ...]):
    return [(f"{p}.weight", (c_out, c_in, *kernel)), (f"{p}.bias", (c_out,))]


def lin(ops: Ops, sd, p: str, x):
    return ops.linear(x, sd[f"{p}.weight"], sd.get(f"{p}.bias"))


def gn(sd, p: str, x, eps: float, silu: bool = False, groups: int = 32):
    return group_norm(x, sd[f"{p}.weight"], sd[f"{p}.bias"], groups, eps, silu)


def ln(sd, p: str, x):
    return layer_norm(x, sd[f"{p}.weight"], sd[f"{p}.bias"])


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """cos then sin of t · 10000^(-i/half), the table built in float64 and
    rounded to float32."""
    half = dim // 2
    freqs = torch.from_numpy(
        np.power(10000.0, -np.arange(half, dtype=np.float64) / half).astype(np.float32)
    ).to(t.device)
    arg = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(arg), torch.sin(arg)], dim=1)


# ---------------------------------------------------------------- attention


def attention_shapes(p: str, dim: int, context_dim: int | None, inner: int):
    kv = context_dim or dim
    return [*linear_shapes(f"{p}.to_q", dim, inner, False),
            *linear_shapes(f"{p}.to_k", kv, inner, False),
            *linear_shapes(f"{p}.to_v", kv, inner, False),
            *linear_shapes(f"{p}.to_out.0", inner, dim)]


def attention(ops: Ops, sd, p: str, x, heads: int, context=None, rel=None):
    """Multi-head attention of (B, N, dim) tokens over themselves or over a
    (B', S, context_dim) context (B' = B, or one context row shared by the
    B / B' token rows that follow it). ``rel`` = (bias_k, bias_v), each
    (N, N, dh): relative-position terms of temporal attention."""
    ctx = x if context is None else context
    q, k, v = lin(ops, sd, f"{p}.to_q", x), lin(ops, sd, f"{p}.to_k", ctx), lin(ops, sd, f"{p}.to_v", ctx)
    b, n, inner = q.shape
    if k.shape[0] != b:
        rep = b // k.shape[0]
        k, v = k.repeat_interleave(rep, dim=0), v.repeat_interleave(rep, dim=0)
    dh = inner // heads
    s = k.shape[1]
    fold = lambda t, length: t.reshape(b, length, heads, dh).transpose(1, 2).reshape(b * heads, length, dh)
    bias_k, bias_v = rel if rel is not None else (None, None)
    o = ops.attention(fold(q, n), fold(k, s), fold(v, s), dh ** -0.5, bias_k, bias_v)
    o = o.reshape(b, heads, n, dh).transpose(1, 2).reshape(b, n, inner)
    return lin(ops, sd, f"{p}.to_out.0", o)


def geglu_shapes(p: str, dim: int, mult: int = 4):
    return [*linear_shapes(f"{p}.net.0.proj", dim, dim * mult * 2),
            *linear_shapes(f"{p}.net.2", dim * mult, dim)]


def geglu(ops: Ops, sd, p: str, x):
    h, gate = lin(ops, sd, f"{p}.net.0.proj", x).chunk(2, dim=-1)
    return lin(ops, sd, f"{p}.net.2", h * F.gelu(gate))


def transformer_block_shapes(p: str, dim: int, context_dim: int | None, heads: int, dh: int):
    inner = heads * dh
    out = [*attention_shapes(f"{p}.attn1", dim, None, inner), *geglu_shapes(f"{p}.ff", dim),
           *attention_shapes(f"{p}.attn2", dim, context_dim, inner)]
    return out + [s for i in (1, 2, 3) for s in norm_shapes(f"{p}.norm{i}", dim)]


def transformer_block(ops: Ops, sd, p: str, x, heads: int, context=None):
    x = attention(ops, sd, f"{p}.attn1", ln(sd, f"{p}.norm1", x), heads) + x
    x = attention(ops, sd, f"{p}.attn2", ln(sd, f"{p}.norm2", x), heads, context) + x
    return geglu(ops, sd, f"{p}.ff", ln(sd, f"{p}.norm3", x)) + x


def conv2d(ops: Ops, sd, p: str, x, stride: int = 1, padding: int = 0):
    return ops.conv2d(x, sd[f"{p}.weight"], sd[f"{p}.bias"], stride, padding)


def upsample_nearest(x, dims=(1, 2)):
    for d in dims:
        x = x.repeat_interleave(2, dim=d)
    return x
