"""Packed-head attention over short key sequences:

* ``fused_self_mha(q/k/v (B, N, H*D), heads, scale)`` -> (B, N, H*D),
  self-attention with N < 512;
* ``fused_cross_mha(q (B, N, H*D), k/v (B, S, H*D), heads, scale)`` ->
  (B, N, H*D), many query rows over a short shared context (S < 512; the
  77-token text context of a whole video's tokens).

The heads stay packed in the minor dimension, as the q/k/v projections
emit them. On a CUDA tensor these launch ``csrc/fused_mha.cu`` (bf16, head
dim 40, 64, 80 or 160); on a CPU tensor they run ``fused_self_mha_plain``
and ``fused_cross_mha_plain``, which fold the heads and run dot-product
attention with an f32 softmax.
"""

from __future__ import annotations

import ctypes

import torch

from t2v_torch.kernels import _build
from t2v_torch.kernels.flash_attention import flash_attention_plain

COUNTER = _build.LaunchCounter()        # fused_self_mha
CROSS_COUNTER = _build.LaunchCounter()  # fused_cross_mha
HEAD_DIMS = (40, 64, 80, 160)
MAX_N = 512
# contexts up to this length sit whole in shared memory; longer ones stream
CROSS_WHOLE_KV = 128


def fused_cross_mha_plain(q, k, v, heads: int, scale: float | None = None) -> torch.Tensor:
    b, n, hd = q.shape
    s = k.shape[1]
    dh = hd // heads
    fold = lambda t, length: t.reshape(b, length, heads, dh).transpose(1, 2).reshape(
        b * heads, length, dh)
    out = flash_attention_plain(fold(q, n), fold(k, s), fold(v, s), scale)
    return out.reshape(b, heads, n, dh).transpose(1, 2).reshape(b, n, hd)


def fused_self_mha_plain(q, k, v, heads: int, scale: float | None = None) -> torch.Tensor:
    return fused_cross_mha_plain(q, k, v, heads, scale)


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


def _launch(entry: str, q, k, v, heads: int, scale: float) -> torch.Tensor:
    b, n, hd = q.shape
    lib = _build.load("fused_mha")
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    o = torch.empty_like(q)
    err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
             b, n, k.shape[1], heads, hd // heads, float(scale), _build.stream_of(q))
    _build.check(err, entry)
    return o


def _self_cuda(q, k, v, heads: int, scale: float) -> torch.Tensor:
    check_args(q, k, v, heads)
    o = _launch("t2v_fused_self_mha", q, k, v, heads, scale)
    COUNTER.hit()
    return o


def _cross_cuda(q, k, v, heads: int, scale: float) -> torch.Tensor:
    check_cross_args(q, k, v, heads)
    whole = k.shape[1] <= CROSS_WHOLE_KV
    o = _launch("t2v_fused_cross_mha" if whole else "t2v_fused_self_mha", q, k, v, heads, scale)
    CROSS_COUNTER.hit()
    return o


def fused_self_mha(q, k, v, heads: int, scale: float | None = None) -> torch.Tensor:
    if scale is None:
        scale = (q.shape[-1] // heads) ** -0.5
    if q.is_cuda:
        return _self_cuda(q, k, v, heads, scale)
    return fused_self_mha_plain(q, k, v, heads, scale)


def fused_cross_mha(q, k, v, heads: int, scale: float | None = None) -> torch.Tensor:
    if scale is None:
        scale = (q.shape[-1] // heads) ** -0.5
    if q.is_cuda:
        return _cross_cuda(q, k, v, heads, scale)
    return fused_cross_mha_plain(q, k, v, heads, scale)
