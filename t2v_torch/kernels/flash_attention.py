"""Flash attention, forward and backward, heads pre-folded into B:

* ``flash_attention(q (B, N, D), k/v (B, S, D), scale)`` -> (B, N, D);
* ``flash_attention_fwd`` -> (out, lse (B, N) f32), the training forward:
  ``lse`` is the log-sum-exp of each row's scaled scores;
* ``flash_attention_bwd(q, k, v, o, lse, do, scale)`` -> (dq, dk, dv) from
  those residuals, the scores recomputed tile by tile.

On a CUDA tensor these launch ``csrc/flash_attention.cu`` and the two
kernels of ``csrc/flash_attention_bwd.cu`` (bf16; D of 40, 64, 80, 160, and
512 forward only); on a CPU tensor they run ``flash_attention_plain``,
``flash_attention_fwd_plain`` and ``flash_attention_bwd_plain`` (its halves
``flash_attention_bwd_dkv_plain`` and ``flash_attention_bwd_dq_plain``):
dot-product attention with an f32 softmax, the probabilities (and, in the
backward, ds) rounded to the storage dtype before their products, as the
kernels feed them. ``flash_attention`` is differentiable on both: on a CUDA
tensor that needs a gradient it runs as ``FlashAttentionFunction``, which
saves (q, k, v, o, lse) and whose backward is the two backward kernels.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from t2v_torch.kernels import _build

COUNTER = _build.LaunchCounter()       # forward
DKV_COUNTER = _build.LaunchCounter()   # backward, dk and dv
DQ_COUNTER = _build.LaunchCounter()    # backward, dq
SUPPORTED_D = (40, 64, 80, 160, 512)
BWD_SUPPORTED_D = (40, 64, 80, 160)

# a block's shared memory (H100 SXM), the forward's ring depth at most, and
# its barriers and tile alignment (mirrored by csrc/flash_attention.cu)
MAX_SMEM = 232448
MAX_STAGES = 4
SMEM_SLACK = 2048


@dataclass(frozen=True)
class FlashPlan:
    """How the forward kernel cuts one call into blocks."""

    bq: int           # query rows a block: 128 (two consumer warpgroups of 64), 64 at d = 512
    bkv: int          # keys a K/V tile
    stages: int       # K/V tiles in flight
    smem_bytes: int
    blocks: int
    column_split: bool  # d = 512: both warpgroups share the query rows, each owns half of O


@functools.lru_cache(maxsize=None)
def flash_plan(b: int, n: int, s: int, d: int) -> FlashPlan:
    """Tiles of the forward for (B, N, D) queries over (B, S, D) keys: 128
    query rows a block up to d = 160, 64 at d = 512 (column split); key
    tiles of 128 up to d = 64 when S exceeds one tile of 64, else 64 (the
    score tile, P and O together stay within a consumer's 168 registers:
    at d = 80 a 128-key tile spilled and serialized its wgmmas); as many
    stages as shared memory holds, up to ``MAX_STAGES`` and no more than the
    key tiles."""
    boxes = -(-d // 64)
    split = d > 160
    bq = 64 if split else 128
    bkv = 128 if d <= 64 and s > 64 else 64
    q_bytes = boxes * bq * 128
    stage = 2 * boxes * bkv * 128
    stages = max(1, min(MAX_STAGES, (MAX_SMEM - SMEM_SLACK - q_bytes) // stage, -(-s // bkv)))
    return FlashPlan(bq, bkv, stages, q_bytes + stages * stage + SMEM_SLACK, b * -(-n // bq),
                     split)


def flash_attention_plain(q, k, v, scale: float | None = None) -> torch.Tensor:
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(v.dtype)


def flash_attention_fwd_plain(q, k, v, scale: float | None = None):
    """(out, lse): the plain forward with the f32 log-sum-exp residual."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(v.dtype), lse


def _recompute_p(q, k, lse, scale: float) -> torch.Tensor:
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.exp(s - lse[..., None])


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, scale: float):
    """(dk, dv) from the dkv kernel's formulas: p from the saved lse, p and
    ds rounded to the storage dtype before their products, f32 sums."""
    p = _recompute_p(q, k, lse, scale)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, scale: float):
    """dq from the dq kernel's formulas."""
    p = _recompute_p(q, k, lse, scale)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta[..., None]) * scale).to(k.dtype).float()
    return torch.matmul(ds, k.float()).to(q.dtype)


def bwd_delta(o, do) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, (B, N): plain torch beside the
    kernels, as it is plain XLA beside the TPU kernels."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_attention_bwd_plain(q, k, v, o, lse, do, scale: float | None = None):
    """(dq, dk, dv) written from the backward kernels' formulas, not through
    autograd."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    delta = bwd_delta(o, do)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, scale)
    return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, scale), dk, dv


def check_args(q, k, v) -> None:
    """Raise ValueError on inputs the CUDA kernel does not take."""
    req = _build.require
    req(q.dim() == 3 and k.dim() == 3 and v.dim() == 3, "flash_attention: q, k, v must be 3-D")
    b, n, d = q.shape
    s = k.shape[1]
    req(tuple(k.shape) == (b, s, d) and tuple(v.shape) == (b, s, d),
        f"flash_attention: k/v must be ({b}, S, {d}), got {tuple(k.shape)}, {tuple(v.shape)}")
    req(all(t.dtype == torch.bfloat16 for t in (q, k, v)),
        "flash_attention: q, k, v must be bfloat16")
    req(all(t.is_contiguous() for t in (q, k, v)), "flash_attention: q, k, v must be contiguous")
    req(k.device == q.device and v.device == q.device, "flash_attention: q, k, v on one device")
    req(d in SUPPORTED_D, f"flash_attention: head dim {d} not in {SUPPORTED_D}")


def check_bwd_args(q, k, v, do, lse, delta) -> None:
    """Raise ValueError on inputs the CUDA backward kernels do not take."""
    req = _build.require
    check_args(q, k, v)
    b, n, d = q.shape
    req(d in BWD_SUPPORTED_D,
        f"flash_attention_bwd: head dim {d} not in {BWD_SUPPORTED_D} (D = 512 is the VAE's "
        "forward-only attention)")
    req(do.shape == q.shape and do.dtype == torch.bfloat16 and do.is_contiguous()
        and do.device == q.device,
        f"flash_attention_bwd: do must be contiguous bfloat16 {tuple(q.shape)} on q's device")
    req(all(tuple(t.shape) == (b, n) and t.dtype == torch.float32 and t.is_contiguous()
            and t.device == q.device for t in (lse, delta)),
        f"flash_attention_bwd: lse and delta must be contiguous float32 ({b}, {n}) on q's device")


@functools.cache
def _fwd_entry():
    """The forward's C entry, its argument types set once."""
    fn = _build.load("flash_attention").t2v_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _flash_cuda(q, k, v, scale: float, save_lse: bool = False):
    check_args(q, k, v)
    b, n, d = q.shape
    s = k.shape[1]
    plan = flash_plan(b, n, s, d)
    o = torch.empty_like(q)
    lse = torch.empty((b, n), device=q.device, dtype=torch.float32) if save_lse else None
    err = _fwd_entry()(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
                       _build.ptr(lse) if save_lse else None,
                       b, n, s, d, float(scale), plan.bkv, plan.stages, _build.stream_of(q))
    _build.check(err, "flash_attention")
    COUNTER.hit()
    return (o, lse) if save_lse else o


def _bwd_launch(entry: str, q, k, v, do, lse, delta, outs, scale: float) -> None:
    check_bwd_args(q, k, v, do, lse, delta)
    b, n, d = q.shape
    fn = getattr(_build.load("flash_attention_bwd"), entry)
    fn.argtypes = ([ctypes.c_void_p] * (6 + len(outs)) + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(*(_build.ptr(t) for t in (q, k, v, do, lse, delta, *outs)),
             b, n, k.shape[1], d, float(scale), _build.stream_of(q))
    _build.check(err, entry)


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale: float):
    """(dk, dv), accumulated over the query tiles."""
    if not q.is_cuda:
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("t2v_flash_attention_bwd_dkv", q, k, v, do, lse, delta, (dk, dv), scale)
    DKV_COUNTER.hit()
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, scale: float):
    """dq, accumulated over the key/value tiles."""
    if not q.is_cuda:
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, scale)
    dq = torch.empty_like(q)
    _bwd_launch("t2v_flash_attention_bwd_dq", q, k, v, do, lse, delta, (dq,), scale)
    DQ_COUNTER.hit()
    return dq


def flash_attention_fwd(q, k, v, scale: float | None = None):
    """Training forward with residuals: (out (B, N, D), lse (B, N) f32)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        return _flash_cuda(q, k, v, scale, save_lse=True)
    return flash_attention_fwd_plain(q, k, v, scale)


def flash_attention_bwd(q, k, v, o, lse, do, scale: float | None = None):
    """(dq, dk, dv) from the saved forward residuals."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    _build.require(o.shape == q.shape and o.dtype == q.dtype and o.device == q.device
                   and do.shape == q.shape,
                   "flash_attention_bwd: o and do must match q")
    delta = bwd_delta(o, do)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale)
    return flash_attention_bwd_dq(q, k, v, do, lse, delta, scale), dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """``apply(q, k, v, scale)``: the forward kernel with its lse output;
    the backward is the dkv and dq kernels on the saved (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # the incoming gradient arrives through the head fold, a strided view
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(), ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale: float | None = None) -> torch.Tensor:
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        if _build.needs_grad(q, k, v):
            return FlashAttentionFunction.apply(q, k, v, scale)
        return _flash_cuda(q, k, v, scale)
    return flash_attention_plain(q, k, v, scale)
