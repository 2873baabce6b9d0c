"""Packed-head attention over short key sequences:

* ``fused_self_mha(q/k/v (B, N, H*D), heads, scale)`` -> (B, N, H*D),
  self-attention with N < 512;
* ``fused_cross_mha(q (B, N, H*D), k/v (B, S, H*D), heads, scale)`` ->
  (B, N, H*D), many query rows over a short shared context (S < 512; the
  77-token text context of a whole video's tokens);
* ``fused_temporal_mha(q/k/v (B*F, N, H*D), heads, f, scale)`` ->
  (B*F, N, H*D), self-attention across the frame axis of sample-major
  tensors (F < 512): rows i*F .. (i+1)*F - 1 are sample i's frames, and
  each spatial token and head attends across them, without the frame <->
  token transpose ever reaching device memory.

The heads stay packed in the minor dimension, as the q/k/v projections
emit them. On a CUDA tensor these launch ``csrc/fused_mha.cu`` (bf16, head
dim 40, 64, 80 or 160); on a CPU tensor they run ``fused_self_mha_plain``,
``fused_cross_mha_plain`` and ``fused_temporal_mha_plain``, which fold the
heads (and, for the last, swap the frame and token axes) and run
dot-product attention with an f32 softmax.

All three are differentiable. On a CUDA tensor that needs a gradient they
run as ``FusedSelfMHAFunction`` / ``FusedCrossMHAFunction`` /
``FusedTemporalMHAFunction``: the forward launches the kernel, the backward
recomputes through the folded dot-product math, as the JAX package's
``custom_vjp`` recomputes through its XLA reference (sequences are short,
so the score matrix is cheap to rebuild).
"""

from __future__ import annotations

import ctypes

import torch

from t2v_torch.kernels import _build
from t2v_torch.kernels.flash_attention import flash_attention_plain

COUNTER = _build.LaunchCounter()           # fused_self_mha
CROSS_COUNTER = _build.LaunchCounter()     # fused_cross_mha
TEMPORAL_COUNTER = _build.LaunchCounter()  # fused_temporal_mha
HEAD_DIMS = (40, 64, 80, 160)
MAX_N = 512
# contexts up to this length sit whole in shared memory; longer ones stream
CROSS_WHOLE_KV = 128


def _folded_attention(q, k, v, heads: int, scale: float | None) -> torch.Tensor:
    """Fold the heads, dot-product attention, unfold: the math of both plain
    versions and of the recompute backward."""
    b, n, hd = q.shape
    s = k.shape[1]
    dh = hd // heads
    fold = lambda t, length: t.reshape(b, length, heads, dh).transpose(1, 2).reshape(
        b * heads, length, dh)
    out = flash_attention_plain(fold(q, n), fold(k, s), fold(v, s), scale)
    return out.reshape(b, heads, n, dh).transpose(1, 2).reshape(b, n, hd)


def swap_frame_axis(t: torch.Tensor, f: int) -> torch.Tensor:
    """Sample-major (B*F, N, D) -> (B*N, F, D) (a materialised transpose)."""
    bf, n, d = t.shape
    return t.reshape(bf // f, f, n, d).transpose(1, 2).reshape(bf // f * n, f, d)


def unswap_frame_axis(t: torch.Tensor, n: int) -> torch.Tensor:
    """(B*N, F, D) -> sample-major (B*F, N, D) (a materialised transpose)."""
    bn, f, d = t.shape
    return t.reshape(bn // n, n, f, d).transpose(1, 2).reshape(bn // n * f, n, d)


def fused_temporal_mha_plain(q, k, v, heads: int, f: int,
                             scale: float | None = None) -> torch.Tensor:
    """Swap the frame and token axes, folded self-attention, swap back: also
    the math of the temporal recompute backward."""
    n = q.shape[1]
    swap = lambda t: swap_frame_axis(t, f)
    return unswap_frame_axis(_folded_attention(swap(q), swap(k), swap(v), heads, scale), n)


def fused_cross_mha_plain(q, k, v, heads: int, scale: float | None = None) -> torch.Tensor:
    return _folded_attention(q, k, v, heads, scale)


def fused_self_mha_plain(q, k, v, heads: int, scale: float | None = None) -> torch.Tensor:
    return _folded_attention(q, k, v, heads, scale)


def fused_mha_backward(q, k, v, heads: int, scale: float | None, grad_out,
                       needs=(True, True, True)):
    """(dq, dk, dv) of either packed attention by recompute through the
    folded dot-product math under autograd."""
    return _build.recompute_grads(
        lambda a, b, c: _folded_attention(a, b, c, heads, scale), (q, k, v), grad_out, needs)


def _check_common(what: str, q, k, v, heads: int) -> None:
    req = _build.require
    req(q.dim() == 3 and k.dim() == 3 and v.dim() == 3, f"{what}: q, k, v must be (B, N, H*D)")
    hd = q.shape[-1]
    req(heads > 0 and hd % heads == 0 and hd // heads in HEAD_DIMS,
        f"{what}: needs a head dim in {HEAD_DIMS}, got {hd}/{heads}")
    req(all(t.dtype == torch.bfloat16 for t in (q, k, v)), f"{what}: q, k, v must be bfloat16")
    req(all(t.is_contiguous() for t in (q, k, v)), f"{what}: q, k, v must be contiguous")
    req(k.device == q.device and v.device == q.device, f"{what}: q, k, v on one device")


def check_args(q, k, v, heads: int) -> None:
    """Raise ValueError on inputs the CUDA self-attention kernel does not take."""
    _check_common("fused_self_mha", q, k, v, heads)
    _build.require(k.shape == q.shape and v.shape == q.shape,
                   "fused_self_mha: q, k, v shapes differ")
    _build.require(q.shape[1] < MAX_N, f"fused_self_mha: N={q.shape[1]} must be below {MAX_N}")


def check_cross_args(q, k, v, heads: int) -> None:
    """Raise ValueError on inputs the CUDA cross-attention kernel does not take."""
    _check_common("fused_cross_mha", q, k, v, heads)
    b, _, hd = q.shape
    _build.require(k.shape == v.shape and k.shape[0] == b and k.shape[2] == hd,
                   f"fused_cross_mha: k/v must be ({b}, S, {hd}), got {tuple(k.shape)}, "
                   f"{tuple(v.shape)}")
    _build.require(0 < k.shape[1] < MAX_N,
                   f"fused_cross_mha: S={k.shape[1]} must be in [1, {MAX_N})")


def check_temporal_args(q, k, v, heads: int, f: int) -> None:
    """Raise ValueError on inputs the CUDA frame-axis kernel does not take."""
    _check_common("fused_temporal_mha", q, k, v, heads)
    _build.require(k.shape == q.shape and v.shape == q.shape,
                   "fused_temporal_mha: q, k, v shapes differ")
    _build.require(0 < f < MAX_N, f"fused_temporal_mha: f={f} must be in [1, {MAX_N})")
    _build.require(q.shape[0] % f == 0,
                   f"fused_temporal_mha: {q.shape[0]} rows are not whole samples of {f} frames")


def _launch(entry: str, q, k, v, ints: tuple[int, ...], scale: float) -> torch.Tensor:
    """Launch a C entry ``(q, k, v, o, *ints, scale, stream)``."""
    lib = _build.load("fused_mha")
    fn = getattr(lib, entry)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * len(ints)
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    o = torch.empty_like(q)
    err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o), *ints, float(scale),
             _build.stream_of(q))
    _build.check(err, entry)
    return o


def _packed_ints(q, k, heads: int) -> tuple[int, ...]:
    b, n, hd = q.shape
    return b, n, k.shape[1], heads, hd // heads


def _self_cuda(q, k, v, heads: int, scale: float) -> torch.Tensor:
    check_args(q, k, v, heads)
    o = _launch("t2v_fused_self_mha", q, k, v, _packed_ints(q, k, heads), scale)
    COUNTER.hit()
    return o


def _cross_cuda(q, k, v, heads: int, scale: float) -> torch.Tensor:
    check_cross_args(q, k, v, heads)
    whole = k.shape[1] <= CROSS_WHOLE_KV
    o = _launch("t2v_fused_cross_mha" if whole else "t2v_fused_self_mha", q, k, v,
                _packed_ints(q, k, heads), scale)
    CROSS_COUNTER.hit()
    return o


def _temporal_cuda(q, k, v, heads: int, f: int, scale: float) -> torch.Tensor:
    check_temporal_args(q, k, v, heads, f)
    bf, n, hd = q.shape
    o = _launch("t2v_fused_temporal_mha", q, k, v, (bf // f, f, n, heads, hd // heads), scale)
    TEMPORAL_COUNTER.hit()
    return o


class _PackedMHAFunction(torch.autograd.Function):
    """``apply(q, k, v, heads, scale)``: the kernel forward (the plain
    version for CPU tensors), the recompute backward."""

    @staticmethod
    def _run(q, k, v, heads, scale):
        raise NotImplementedError

    @classmethod
    def forward(cls, ctx, q, k, v, heads, scale):
        ctx.save_for_backward(q, k, v)
        ctx.heads, ctx.scale = heads, scale
        return cls._run(q, k, v, heads, scale)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        return (*fused_mha_backward(q, k, v, ctx.heads, ctx.scale, grad_out,
                                    ctx.needs_input_grad[:3]), None, None)


class FusedSelfMHAFunction(_PackedMHAFunction):
    @staticmethod
    def _run(q, k, v, heads, scale):
        if q.is_cuda:
            return _self_cuda(q, k, v, heads, scale)
        return fused_self_mha_plain(q, k, v, heads, scale)


class FusedCrossMHAFunction(_PackedMHAFunction):
    @staticmethod
    def _run(q, k, v, heads, scale):
        if q.is_cuda:
            return _cross_cuda(q, k, v, heads, scale)
        return fused_cross_mha_plain(q, k, v, heads, scale)


class FusedTemporalMHAFunction(torch.autograd.Function):
    """``apply(q, k, v, heads, f, scale)``: the kernel forward (the plain
    version for CPU tensors), the backward by recompute through the
    swap-fold-attend math, as the JAX package's ``_fused_temporal_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, heads, f, scale):
        ctx.save_for_backward(q, k, v)
        ctx.heads, ctx.f, ctx.scale = heads, f, scale
        if q.is_cuda:
            return _temporal_cuda(q, k, v, heads, f, scale)
        return fused_temporal_mha_plain(q, k, v, heads, f, scale)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        grads = _build.recompute_grads(
            lambda a, b, c: fused_temporal_mha_plain(a, b, c, ctx.heads, ctx.f, ctx.scale), (q, k, v),
            grad_out, ctx.needs_input_grad[:3])
        return (*grads, None, None, None)


def fused_self_mha(q, k, v, heads: int, scale: float | None = None) -> torch.Tensor:
    if scale is None:
        scale = (q.shape[-1] // heads) ** -0.5
    if q.is_cuda:
        if _build.needs_grad(q, k, v):
            return FusedSelfMHAFunction.apply(q, k, v, heads, scale)
        return _self_cuda(q, k, v, heads, scale)
    return fused_self_mha_plain(q, k, v, heads, scale)


def fused_cross_mha(q, k, v, heads: int, scale: float | None = None) -> torch.Tensor:
    if scale is None:
        scale = (q.shape[-1] // heads) ** -0.5
    if q.is_cuda:
        if _build.needs_grad(q, k, v):
            return FusedCrossMHAFunction.apply(q, k, v, heads, scale)
        return _cross_cuda(q, k, v, heads, scale)
    return fused_cross_mha_plain(q, k, v, heads, scale)


def fused_temporal_mha(q, k, v, heads: int, f: int, scale: float | None = None) -> torch.Tensor:
    if scale is None:
        scale = (q.shape[-1] // heads) ** -0.5
    if q.is_cuda:
        if _build.needs_grad(q, k, v):
            return FusedTemporalMHAFunction.apply(q, k, v, heads, f, scale)
        return _temporal_cuda(q, k, v, heads, f, scale)
    return fused_temporal_mha_plain(q, k, v, heads, f, scale)
