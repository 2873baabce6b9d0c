"""Fused GroupNorm -> SiLU -> (3,1,1) temporal conv chain of the ResBlock's
TemporalConvBlock.

Contract (the JAX package's ``temporal_conv_chain``): ``x`` is
``(B, F, HW, C)``; ``layers`` holds four tuples ``(gn_scale (C,),
gn_bias (C,), w (3, C_in, C_out), conv_bias (C,))``. Each layer normalises
with GroupNorm(32) statistics in f32, applies the affine and SiLU, rounds
to the weight dtype, runs the three frame-shifted GEMMs with zero frame
padding and f32 accumulation, and adds the conv bias in the activation
dtype; the last layer adds the chain input. A layer's epilogue emits the
per-channel sum and sum^2 of its rounded output, which the next layer's
GroupNorm needs, so no statistics pass re-reads the tensor.

On a CUDA tensor each layer is one call of ``csrc/temporal_conv.cu`` at
any frame count (the JAX package needs a second, frame-chunked kernel for
125 and 250 frames; here a row tile may span frames and the GroupNorm
statistics are finalised over every tile, so they stay global and exact):
an activation pass, whose blocks first fold the GroupNorm into one scale and
shift per (sample, channel) (``xn = x * a + b``, ``a = inv * scale``,
``b = bias - mu * a``; inside the chain they also finalise the statistics
from the previous layer's raw sums, so the O(B*C) glue costs no launch),
then a wgmma GEMM fed by TMA whose tile shape ``layer_plan`` picks per
shape, then a fixed-order sum of the GEMM's per-row-tile statistics. On a
CPU tensor it is ``layer_plain``, and the statistics glue (``input_stats``,
``finalize_stats``) is plain torch. ``temporal_conv_chain`` sends a chain
to the kernel only when ``chain_takes`` its input (bf16, C a multiple of
64); any other input on the card runs ``chain_plain`` there.

``temporal_conv_chain`` is differentiable. On a CUDA tensor that needs a
gradient it runs as ``TemporalConvChainFunction``: the forward launches the
four layer kernels, the backward (``chain_backward``) recomputes the chain
through the plain layer math and returns gradients for x and all sixteen
layer tensors, as the JAX package's ``custom_vjp`` recomputes through
``chain_ref``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from t2v_torch.kernels import _build

NUM_GROUPS = 32
COUNTER = _build.LaunchCounter()


# elements upcast to f32 at a time by ``input_stats``: a 24-frame level is
# one chunk, a 250-frame level is walked in frame chunks of about 128 MB
STATS_CHUNK_ELEMENTS = 1 << 25


def input_stats(x: torch.Tensor) -> torch.Tensor:
    """(B, 2, C) raw per-channel sum and sum^2 of the chain input, summed in
    f32 over frame chunks so that a long video is never upcast whole."""
    b, f, hw, c = x.shape
    step = max(1, STATS_CHUNK_ELEMENTS // max(1, b * hw * c))
    s1 = s2 = None
    for f0 in range(0, f, step):
        x32 = x[:, f0 : f0 + step].float()
        c1, c2 = x32.sum(dim=(1, 2)), (x32 * x32).sum(dim=(1, 2))
        s1, s2 = (c1, c2) if s1 is None else (s1 + c1, s2 + c2)
    return torch.stack([s1, s2], dim=1)


def finalize_stats(raw: torch.Tensor, n_el: int, eps: float) -> torch.Tensor:
    """(B, 2, C) channel sums -> (B, 2, C) per-channel [mu; 1/sigma] of
    GroupNorm(32), with the variance taken as E[x^2] - mu^2 in f32."""
    b, _, c = raw.shape
    gs = c // NUM_GROUPS
    g = raw.reshape(b, 2, NUM_GROUPS, gs).sum(-1)
    cnt = n_el * gs
    mu = g[:, 0] / cnt
    var = g[:, 1] / cnt - mu * mu
    inv = torch.rsqrt(var + eps)
    return torch.stack(
        [mu.repeat_interleave(gs, dim=-1), inv.repeat_interleave(gs, dim=-1)], dim=1
    )


def _layer_math(x, fin, scale, bias, w, cb, residual, emit_stats):
    """One layer in plain torch: the math of ``layer_plain`` and of the
    chain's recompute backward."""
    b, f, hw, c = x.shape
    mu = fin[:, 0].reshape(b, 1, 1, c)
    inv = fin[:, 1].reshape(b, 1, 1, c)
    xn = (x.float() - mu) * inv * scale.float() + bias.float()
    a = F.silu(xn).to(w.dtype).float()
    a_pad = F.pad(a, (0, 0, 0, 0, 1, 1))
    w32 = w.float()
    acc = a_pad[:, 0:f] @ w32[0] + a_pad[:, 1 : f + 1] @ w32[1] + a_pad[:, 2 : f + 2] @ w32[2]
    y = acc.to(x.dtype) + cb.to(x.dtype)
    if residual is not None:
        y = y + residual
    if not emit_stats:
        return y, None
    return y, input_stats(y)


# the card's SM count and shared memory a block may take (H100 SXM)
SMS = 132
MAX_SMEM = 232448
# a K step is 64 channels: one 128-byte row of a TMA box
BK = 64
# barriers, the tile's conv bias and the 1024-byte alignment of the swizzled tiles
SMEM_SLACK = 3072
MAX_STAGES = 6
# (rows, columns) of a block's output tile; a tile of 128 rows runs two
# consumer warpgroups, 64 rows one. Wider tiles than 256 columns need more
# than the 168 registers a thread of three warpgroups starts with: a
# 128 x 320 tile spilled and measured slower than 64 x 320 on an H100
TILES = ((128, 256), (128, 128), (64, 256), (128, 64), (64, 128), (64, 64))
# bytes one SM moves a second from L2 into shared memory, for the tile
# choice (a model constant, set so that the model ranks the tiles as their
# times on an H100 did). Every tile is L2-bound at this rate: the densest,
# 128 x 256, does 85 flops a byte so moved, and the tensor cores (989
# TFLOP/s over 132 SMs) would bound a tile only above about 159
SM_L2_BYTES = 47e9


@dataclass(frozen=True)
class LayerPlan:
    """Tile and ring of the GEMM kernel for one layer shape."""

    bm: int           # output rows of a block (a row tile never spans samples)
    bn: int           # output channels of a full column tile
    last_cols: int    # channels of the last column tile: bn, or fewer when it is ragged
    stages: int       # depth of the shared-memory ring
    smem_bytes: int   # dynamic shared memory of a block
    row_tiles: int    # ceil(F * HW / bm): partial-statistics rows per sample
    col_tiles: int    # ceil(C / bn)
    blocks: int       # B * row_tiles * col_tiles
    est_us: float     # the cost model's time, for the choice only

    @staticmethod
    def stage_bytes(bm: int, bn: int) -> int:
        return bm * BK * 2 + bn * BK * 2

    @staticmethod
    def epilogue_bytes(bm: int, bn: int) -> int:
        """The staged bf16 output tile and the per-warp column sums, which
        reuse the ring once the main loop is done."""
        return bm * bn * 2 + (bm // 16) * bn * 8


def _tile_seconds(bm: int, cols: int, k: int) -> float:
    """One tile's GEMM time: its A and W boxes' bytes from L2."""
    return 2.0 * (bm + cols) * k / SM_L2_BYTES


@functools.lru_cache(maxsize=None)
def layer_plan(b: int, f: int, hw: int, c: int) -> LayerPlan:
    """Among the tiles that give at least one block per SM (all tiles, for
    a shape too small for any), the one with the least modelled time: the
    blocks' mean time (``_tile_seconds``, over the full column tiles and a
    ragged last one) times the waves of blocks the card runs them in.
    ``C`` is a multiple of 64, so a ragged last column tile is whole
    64-wide boxes. The ring takes as many stages as shared memory holds,
    up to six."""
    m, k = f * hw, 3 * c
    plans = []
    for bm, bn in TILES:
        full, rest = divmod(c, bn)
        widths = [bn] * full + ([rest] if rest else [])
        row_tiles = -(-m // bm)
        blocks = b * row_tiles * len(widths)
        mean = sum(_tile_seconds(bm, w, k) for w in widths) / len(widths)
        stage = LayerPlan.stage_bytes(bm, bn)
        stages = min(MAX_STAGES, (MAX_SMEM - SMEM_SLACK) // stage)
        smem = max(stages * stage, LayerPlan.epilogue_bytes(bm, bn)) + SMEM_SLACK
        plans.append(LayerPlan(bm, bn, widths[-1], stages, smem, row_tiles, len(widths), blocks,
                               -(-blocks // SMS) * mean * 1e6))
    filling = [p for p in plans if p.blocks >= SMS] or plans
    return min(filling, key=lambda p: p.est_us)


def layer_plain(
    x: torch.Tensor, fin: torch.Tensor, scale, bias, w, cb,
    residual: torch.Tensor | None = None, emit_stats: bool = True,
):
    """Plain PyTorch version of one layer: returns ``(y, raw_stats)``, with
    ``raw_stats`` None when ``emit_stats`` is false."""
    return _layer_math(x, fin, scale, bias, w, cb, residual, emit_stats)


def check_layer_args(x, fin, scale, bias, w, cb, residual=None) -> None:
    """Raise ValueError on inputs the CUDA layer kernel does not take."""
    if x.dim() != 4:
        raise ValueError(f"temporal_conv: x must be (B, F, HW, C), got {tuple(x.shape)}")
    b, f, hw, c = x.shape
    if x.dtype != torch.bfloat16:
        raise ValueError(f"temporal_conv: x must be bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("temporal_conv: x must be contiguous (B, F, HW, C)")
    if c % 64:
        raise ValueError(f"temporal_conv: C={c} must be a multiple of 64")
    if w.shape != (3, c, c):
        raise ValueError(f"temporal_conv: w must be (3, {c}, {c}), got {tuple(w.shape)}")
    dev = x.device
    if w.dtype != torch.bfloat16 or not w.is_contiguous() or w.device != dev:
        raise ValueError("temporal_conv: w must be contiguous bfloat16 on x's device")
    if fin.shape != (b, 2, c) or fin.dtype != torch.float32 or fin.device != dev:
        raise ValueError("temporal_conv: stats must be float32 (B, 2, C) on x's device")
    if not all(t.shape == (c,) and t.device == dev for t in (scale, bias, cb)):
        raise ValueError(
            f"temporal_conv: GroupNorm scale, bias and conv bias must be ({c},) on x's device")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype
                                 or not residual.is_contiguous() or residual.device != dev):
        raise ValueError("temporal_conv: residual must match x")


@functools.cache
def _entry():
    """The C entry of ``csrc/temporal_conv.cu``, its argument types set once."""
    fn = _build.load("temporal_conv").t2v_temporal_conv_layer
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _layer_cuda(x, stats, scale, bias, w, cb, residual, emit_stats, raw_eps):
    """One layer kernel call (three launches): the activation pass, the
    GEMM and the sum of its per-row-tile statistics. ``stats`` is the
    finalised (B, 2, C) [mu; 1/sigma], or, when ``raw_eps`` is given, the
    raw [sum; sum^2] of the layer input, which the activation pass
    finalises with that eps."""
    check_layer_args(x, stats, scale, bias, w, cb, residual)
    b, f, hw, c = x.shape
    plan = layer_plan(b, f, hw, c)
    affine_bf16 = scale.dtype == torch.bfloat16 and bias.dtype == torch.bfloat16
    if not affine_bf16:
        scale, bias = scale.float(), bias.float()
    if cb.dtype != torch.bfloat16:
        cb = cb.to(torch.bfloat16)
    scale, bias, cb = scale.contiguous(), bias.contiguous(), cb.contiguous()
    stats = stats.contiguous()
    act = torch.empty_like(x)
    y = torch.empty_like(x)
    partial = out_stats = None
    if emit_stats:
        partial = x.new_empty((b, plan.row_tiles, 2, c), dtype=torch.float32)
        out_stats = x.new_empty((b, 2, c), dtype=torch.float32)
    ptr = _build.ptr
    err = _entry()(
        ptr(x), ptr(stats), ptr(scale), ptr(bias), ptr(w), ptr(cb),
        ptr(residual) if residual is not None else None, ptr(act), ptr(y),
        ptr(partial) if emit_stats else None, ptr(out_stats) if emit_stats else None,
        b, f, hw, c, int(affine_bf16), int(raw_eps is not None),
        raw_eps if raw_eps is not None else 0.0, plan.bm, plan.bn, plan.stages,
        _build.stream_of(x),
    )
    _build.check(err, "temporal_conv_layer")
    COUNTER.hit()
    return y, out_stats


def temporal_conv_layer(
    x: torch.Tensor, stats: torch.Tensor, scale, bias, w, cb,
    residual: torch.Tensor | None = None, emit_stats: bool = True, raw_eps: float | None = None,
):
    """One layer: the kernel for a CUDA tensor, the plain version for a CPU
    tensor. ``stats`` is the finalised (B, 2, C) [mu; 1/sigma], or, when
    ``raw_eps`` is given, the raw [sum; sum^2] that the chain carries from
    layer to layer, finalised with that eps (inside the kernel on the
    card). Returns ``(y, raw_stats)``, ``raw_stats`` None when
    ``emit_stats`` is false."""
    if x.is_cuda:
        return _layer_cuda(x, stats, scale, bias, w, cb, residual, emit_stats, raw_eps)
    if raw_eps is not None:
        stats = finalize_stats(stats, x.shape[1] * x.shape[2], raw_eps)
    return layer_plain(x, stats, scale, bias, w, cb, residual, emit_stats)


def chain_plain(x: torch.Tensor, layers, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of the whole chain, statistics recomputed from
    each layer's output (the JAX package's ``chain_ref``)."""
    return _chain_math(x, layers, eps)


def _chain_math(x, layers, eps: float) -> torch.Tensor:
    h = x
    n_el = x.shape[1] * x.shape[2]
    for scale, bias, w, cb in layers:
        fin = finalize_stats(input_stats(h), n_el, eps)
        h, _ = _layer_math(h, fin, scale, bias, w, cb, None, False)
    return x + h


def chain_backward(x, layers, eps: float, grad_out, needs=None):
    """Gradients of the chain for ``x`` and the flattened layer tensors
    (scale, bias, w, conv bias of each layer, in order), by recompute
    through the plain layer math under autograd. ``needs`` flags which of
    the 1 + 4 * len(layers) inputs want one (default: all)."""
    flat = [x, *(t for layer in layers for t in layer)]
    needs = tuple(needs) if needs is not None else (True,) * len(flat)

    def fn(xx, *ts):
        return _chain_math(xx, [ts[i : i + 4] for i in range(0, len(ts), 4)], eps)

    return _build.recompute_grads(fn, flat, grad_out, needs)


class TemporalConvChainFunction(torch.autograd.Function):
    """``apply(eps, x, *layer_tensors)``: the chain's forward (kernels for a
    CUDA tensor), the recompute backward."""

    @staticmethod
    def forward(ctx, eps, x, *flat):
        ctx.save_for_backward(x, *flat)
        ctx.eps = eps
        return _chain_forward(x, [flat[i : i + 4] for i in range(0, len(flat), 4)], eps)

    @staticmethod
    def backward(ctx, grad_out):
        x, *flat = ctx.saved_tensors
        layers = [flat[i : i + 4] for i in range(0, len(flat), 4)]
        return (None, *chain_backward(x, layers, ctx.eps, grad_out, ctx.needs_input_grad[1:]))


def chain_takes(x: torch.Tensor) -> bool:
    """Whether the layer kernel takes the chain input ``x`` (B, F, HW, C):
    on the card, bf16, and C a multiple of 64."""
    return _build.on_card(x) and x.dtype == torch.bfloat16 and x.shape[-1] % 64 == 0


def temporal_conv_chain(x: torch.Tensor, layers, eps: float = 1e-5) -> torch.Tensor:
    """The fused TemporalConvBlock: identity + four GN->SiLU->conv layers,
    each layer's GroupNorm statistics taken from the previous layer's
    epilogue. Returns a tensor of x's shape and dtype. On the card, an
    input the kernel does not take (a float32 model) runs ``chain_plain``
    there, autograd and all."""
    if _build.on_card(x) and not chain_takes(x):
        return chain_plain(x, layers, eps)
    flat = [t for layer in layers for t in layer]
    if x.is_cuda and _build.needs_grad(x, *flat):
        return TemporalConvChainFunction.apply(eps, x, *flat)
    return _chain_forward(x, layers, eps)


def _chain_forward(x: torch.Tensor, layers, eps: float) -> torch.Tensor:
    raw = input_stats(x)
    h = x
    n = len(layers)
    for i, (scale, bias, w, cb) in enumerate(layers):
        last = i == n - 1
        h, raw = temporal_conv_layer(h, raw, scale, bias, w, cb, residual=x if last else None,
                                     emit_stats=not last, raw_eps=eps)
    return h
