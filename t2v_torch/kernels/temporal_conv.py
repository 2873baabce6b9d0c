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

On a CUDA tensor each layer is one launch of ``csrc/temporal_conv.cu`` at
any frame count (the JAX package needs a second, frame-chunked kernel for
125 and 250 frames; here a row tile may span frames and the GroupNorm
statistics are finalised over every tile, so they stay global and exact);
on a CPU tensor it is ``layer_plain``. The O(B*C) statistics glue
(``input_stats``, ``finalize_stats``) is plain torch on both.

``temporal_conv_chain`` is differentiable. On a CUDA tensor that needs a
gradient it runs as ``TemporalConvChainFunction``: the forward launches the
four layer kernels, the backward (``chain_backward``) recomputes the chain
through the plain layer math and returns gradients for x and all sixteen
layer tensors, as the JAX package's ``custom_vjp`` recomputes through
``chain_ref``.
"""

from __future__ import annotations

import ctypes

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


def layer_plain(
    x: torch.Tensor, fin: torch.Tensor, scale, bias, w, cb,
    residual: torch.Tensor | None = None, emit_stats: bool = True,
):
    """Plain PyTorch version of one layer: returns ``(y, raw_stats)``, with
    ``raw_stats`` None when ``emit_stats`` is false."""
    return _layer_math(x, fin, scale, bias, w, cb, residual, emit_stats)


def check_layer_args(x, fin, scale, bias, w, cb, residual=None) -> None:
    """Raise ValueError on inputs the CUDA layer kernel does not take."""
    req = _build.require
    req(x.dim() == 4, f"temporal_conv: x must be (B, F, HW, C), got {tuple(x.shape)}")
    b, f, hw, c = x.shape
    req(x.dtype == torch.bfloat16, f"temporal_conv: x must be bfloat16, got {x.dtype}")
    req(x.is_contiguous(), "temporal_conv: x must be contiguous (B, F, HW, C)")
    req(c % 64 == 0, f"temporal_conv: C={c} must be a multiple of 64")
    req(tuple(w.shape) == (3, c, c), f"temporal_conv: w must be (3, {c}, {c}), got {tuple(w.shape)}")
    req(w.dtype == torch.bfloat16 and w.is_contiguous() and w.device == x.device,
        "temporal_conv: w must be contiguous bfloat16 on x's device")
    req(tuple(fin.shape) == (b, 2, c) and fin.dtype == torch.float32 and fin.device == x.device,
        "temporal_conv: stats must be float32 (B, 2, C) on x's device")
    req(all(t.shape == (c,) and t.device == x.device for t in (scale, bias, cb)),
        f"temporal_conv: GroupNorm scale, bias and conv bias must be ({c},) on x's device")
    if residual is not None:
        req(residual.shape == x.shape and residual.dtype == x.dtype and residual.is_contiguous()
            and residual.device == x.device, "temporal_conv: residual must match x")


def _layer_cuda(x, fin, scale, bias, w, cb, residual, emit_stats):
    check_layer_args(x, fin, scale, bias, w, cb, residual)
    b, f, hw, c = x.shape
    lib = _build.load("temporal_conv")
    lib.t2v_temporal_conv_layer.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.t2v_temporal_conv_layer.restype = ctypes.c_int
    lib.t2v_temporal_conv_row_tiles.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.t2v_temporal_conv_row_tiles.restype = ctypes.c_int

    fin = fin.contiguous()
    scale32 = scale.float().contiguous()
    bias32 = bias.float().contiguous()
    cb16 = cb.to(torch.bfloat16).contiguous()
    y = torch.empty_like(x)
    partial = None
    if emit_stats:
        tiles = lib.t2v_temporal_conv_row_tiles(f, hw)
        partial = torch.empty((b, tiles, 2, c), device=x.device, dtype=torch.float32)
    err = lib.t2v_temporal_conv_layer(
        _build.ptr(x), _build.ptr(fin), _build.ptr(scale32), _build.ptr(bias32),
        _build.ptr(w), _build.ptr(cb16),
        _build.ptr(residual) if residual is not None else None,
        _build.ptr(y), _build.ptr(partial) if partial is not None else None,
        b, f, hw, c, _build.stream_of(x),
    )
    _build.check(err, "temporal_conv_layer")
    COUNTER.hit()
    return y, (partial.sum(dim=1) if partial is not None else None)


def temporal_conv_layer(
    x: torch.Tensor, fin: torch.Tensor, scale, bias, w, cb,
    residual: torch.Tensor | None = None, emit_stats: bool = True,
):
    """One layer: the kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    if x.is_cuda:
        return _layer_cuda(x, fin, scale, bias, w, cb, residual, emit_stats)
    return layer_plain(x, fin, scale, bias, w, cb, residual, emit_stats)


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


def temporal_conv_chain(x: torch.Tensor, layers, eps: float = 1e-5) -> torch.Tensor:
    """The fused TemporalConvBlock: identity + four GN->SiLU->conv layers,
    each layer's GroupNorm statistics taken from the previous layer's
    epilogue. Returns a tensor of x's shape and dtype."""
    flat = [t for layer in layers for t in layer]
    if x.is_cuda and _build.needs_grad(x, *flat):
        return TemporalConvChainFunction.apply(eps, x, *flat)
    return _chain_forward(x, layers, eps)


def _chain_forward(x: torch.Tensor, layers, eps: float) -> torch.Tensor:
    n_el = x.shape[1] * x.shape[2]
    raw = input_stats(x)
    h = x
    n = len(layers)
    for i, (scale, bias, w, cb) in enumerate(layers):
        last = i == n - 1
        h, raw = temporal_conv_layer(
            h, finalize_stats(raw, n_el, eps), scale, bias, w, cb,
            residual=x if last else None, emit_stats=not last,
        )
    return h
