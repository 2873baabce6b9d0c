"""Packed-head self-attention over short sequences:
``fused_self_mha(q/k/v (B, N, H*D), heads, scale)`` -> (B, N, H*D).

The heads stay packed in the minor dimension, as the q/k/v projections
emit them. On a CUDA tensor this launches ``csrc/fused_mha.cu`` (bf16,
head dim 64, N < 512); on a CPU tensor it runs ``fused_self_mha_plain``,
which folds the heads and runs dot-product attention with an f32 softmax.
"""

from __future__ import annotations

import ctypes

import torch

from t2v_torch.kernels import _build
from t2v_torch.kernels.flash_attention import flash_attention_plain

COUNTER = _build.LaunchCounter()
HEAD_DIM = 64
MAX_N = 512


def fused_self_mha_plain(q, k, v, heads: int, scale: float | None = None) -> torch.Tensor:
    b, n, hd = q.shape
    dh = hd // heads
    fold = lambda t: t.reshape(b, n, heads, dh).transpose(1, 2).reshape(b * heads, n, dh)
    out = flash_attention_plain(fold(q), fold(k), fold(v), scale)
    return out.reshape(b, heads, n, dh).transpose(1, 2).reshape(b, n, hd)


def check_args(q, k, v, heads: int) -> None:
    """Raise ValueError on inputs the CUDA kernel does not take."""
    req = _build.require
    req(q.dim() == 3, "fused_self_mha: q must be (B, N, H*D)")
    b, n, hd = q.shape
    req(k.shape == q.shape and v.shape == q.shape, "fused_self_mha: q, k, v shapes differ")
    req(hd == heads * HEAD_DIM, f"fused_self_mha: needs head dim {HEAD_DIM}, got {hd}/{heads}")
    req(n < MAX_N, f"fused_self_mha: N={n} must be below {MAX_N}")
    req(all(t.dtype == torch.bfloat16 for t in (q, k, v)), "fused_self_mha: q, k, v must be bfloat16")
    req(all(t.is_contiguous() for t in (q, k, v)), "fused_self_mha: q, k, v must be contiguous")
    req(k.device == q.device and v.device == q.device, "fused_self_mha: q, k, v on one device")


def _fused_cuda(q, k, v, heads: int, scale: float) -> torch.Tensor:
    check_args(q, k, v, heads)
    b, n, hd = q.shape
    lib = _build.load("fused_mha")
    fn = lib.t2v_fused_self_mha
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    o = torch.empty_like(q)
    err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
             b, n, heads, float(scale), _build.stream_of(q))
    _build.check(err, "fused_self_mha")
    COUNTER.hit()
    return o


def fused_self_mha(q, k, v, heads: int, scale: float | None = None) -> torch.Tensor:
    if scale is None:
        scale = (q.shape[-1] // heads) ** -0.5
    if q.is_cuda:
        return _fused_cuda(q, k, v, heads, scale)
    return fused_self_mha_plain(q, k, v, heads, scale)
