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
dim 40, 64, 80 or 160; the self, frame-axis and long-context cross entries
under the per-shape plan of ``self_mha_plan``); on a CPU tensor they run
``fused_self_mha_plain``,
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
import functools
from dataclasses import dataclass

import torch

from t2v_torch.kernels import _build
from t2v_torch.kernels.flash_attention import flash_attention_plain

COUNTER = _build.LaunchCounter()           # fused_self_mha
CROSS_COUNTER = _build.LaunchCounter()     # fused_cross_mha
TEMPORAL_COUNTER = _build.LaunchCounter()  # fused_temporal_mha
HEAD_DIMS = (40, 64, 80, 160)
MAX_N = 512

# query rows of a warp's tile, the card's SMs and a block's shared memory
# (H100 SXM), and the blocks a plan aims for: two for each SM
QT = 16
SMS = 132
MAX_SMEM = 232448
MIN_BLOCKS = 2 * SMS
# query tiles a block takes at most when it packs several short sequences
PACK_TILES = 8


@dataclass(frozen=True)
class MHAPlan:
    """How ``packed_mha_kernel`` cuts one call into blocks."""

    dp: int               # head dim rounded up to a multiple of 16
    kc: int               # key rows of a K/V chunk in shared memory
    warps: int            # warps a block; each takes one 16-row query tile a round
    pairs_per_block: int  # (sequence, head) pairs a block owns
    tiles_per_block: int  # query tiles of each pair a block owns
    resident: bool        # the block's whole K/V is loaded once; else streamed per round
    smem_bytes: int
    blocks: int

    def ints(self) -> tuple[int, ...]:
        """The plan as the C entries take it."""
        return (self.kc, self.warps, self.pairs_per_block, self.tiles_per_block,
                int(self.resident))


@functools.lru_cache(maxsize=None)
def self_mha_plan(n_seq: int, n: int, s: int, heads: int, d: int) -> MHAPlan:
    """Plan for ``n_seq`` sequences of ``n`` queries over ``s`` keys with
    ``heads`` heads of ``d``. A block reads each of its (sequence, head)
    pairs' K/V from device memory once: whole when it fits shared memory
    (every path shape), else in a double buffer once per round of query
    tiles. Sequences of one key chunk are packed several to a block, up to
    ``PACK_TILES`` query tiles, and a long sequence's query tiles are split
    over blocks, each while at least ``MIN_BLOCKS`` blocks remain."""
    dp = next(p for p in (48, 64, 80, 160) if d <= p)
    # 32-row key chunks at D = 160 (registers), for a sequence of one such
    # chunk, and where they pad the keys less (77 keys: 96 against 128)
    kc = 32 if s <= 32 or dp == 160 or -(-s // 32) * 32 < -(-s // 64) * 64 else 64
    n_chunks = -(-s // kc)
    n_qt = -(-n // QT)
    pairs = n_seq * heads
    row = (dp + 8) * 2
    ppb = 1
    while n_chunks == 1 and 2 * ppb * n_qt <= PACK_TILES and pairs >= 2 * ppb * MIN_BLOCKS:
        ppb *= 2
    tpb = n_qt
    while tpb > 1 and -(-pairs // ppb) * -(-n_qt // tpb) < MIN_BLOCKS:
        tpb = -(-tpb // 2)
    items = ppb * tpb
    # a block of several short sequences runs 4 warps (two rounds of its 8
    # tiles), one long sequence 8 (measured faster on both)
    warps = next(w for w in ((4, 2, 1) if ppb > 1 else (8, 4, 2, 1)) if items >= w)
    q_bytes = warps * QT * row
    chunk_bytes = 2 * kc * row
    resident = ppb * n_chunks * chunk_bytes + q_bytes <= MAX_SMEM
    smem = (ppb * n_chunks if resident else 2) * chunk_bytes + q_bytes
    return MHAPlan(dp, kc, warps, ppb, tpb, resident, smem,
                   -(-pairs // ppb) * -(-n_qt // tpb))


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


@functools.cache
def _entry(name: str, n_ints: int, n_plan_ints: int):
    """A C entry ``(q, k, v, o, *ints, scale, *plan, stream)`` of
    ``csrc/fused_mha.cu``, its argument types set once."""
    fn = getattr(_build.load("fused_mha"), name)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * n_ints + [ctypes.c_float]
                   + [ctypes.c_int] * n_plan_ints + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(entry: str, q, k, v, ints: tuple[int, ...], scale: float,
            plan: MHAPlan) -> torch.Tensor:
    """Launch a C entry ``(q, k, v, o, *ints, scale, *plan, stream)``."""
    plan_ints = plan.ints()
    fn = _entry(entry, len(ints), len(plan_ints))
    o = torch.empty_like(q)
    err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o), *ints, float(scale),
             *plan_ints, _build.stream_of(q))
    _build.check(err, entry)
    return o


def _packed_ints(q, k, heads: int) -> tuple[int, ...]:
    b, n, hd = q.shape
    return b, n, k.shape[1], heads, hd // heads


def _packed_plan(q, k, heads: int) -> MHAPlan:
    b, n, hd = q.shape
    return self_mha_plan(b, n, k.shape[1], heads, hd // heads)


def _self_cuda(q, k, v, heads: int, scale: float) -> torch.Tensor:
    check_args(q, k, v, heads)
    o = _launch("t2v_fused_self_mha", q, k, v, _packed_ints(q, k, heads), scale,
                _packed_plan(q, k, heads))
    COUNTER.hit()
    return o


def _cross_cuda(q, k, v, heads: int, scale: float) -> torch.Tensor:
    check_cross_args(q, k, v, heads)
    o = _launch("t2v_fused_self_mha", q, k, v, _packed_ints(q, k, heads), scale,
                _packed_plan(q, k, heads))
    CROSS_COUNTER.hit()
    return o


def _temporal_cuda(q, k, v, heads: int, f: int, scale: float) -> torch.Tensor:
    check_temporal_args(q, k, v, heads, f)
    bf, n, hd = q.shape
    plan = self_mha_plan(bf // f * n, f, f, heads, hd // heads)
    o = _launch("t2v_fused_temporal_mha", q, k, v, (bf // f, f, n, heads, hd // heads), scale,
                plan)
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
