"""Attention dispatch of the port, as in the JAX package's
``kernels/attention.py``:

* ``attention`` on head-folded (B, N, D): a key length >= ``FLASH_MIN_KV``
  on a CUDA tensor goes to the flash kernel; shorter keys (the 77-token
  cross-attention, which the JAX package also leaves to plain XLA math)
  and CPU tensors go to ``attention_plain``;
* ``self_attention_packed`` on packed heads (B, N, H·D): on a CUDA tensor
  N < ``FLASH_MIN_KV`` goes to the packed short-sequence kernel and longer
  sequences are folded and go to flash; CPU tensors take the plain path;
* ``cross_attention_packed`` on packed heads, q (B, N, H·D) over a shared
  context k/v (B, S, H·D): on a CUDA tensor S < ``FLASH_MIN_KV`` goes to
  the packed cross-attention kernel, longer contexts fold and go to flash;
  CPU tensors take the plain path.
"""

from __future__ import annotations

from t2v_torch.kernels.flash_attention import flash_attention
from t2v_torch.kernels.flash_attention import flash_attention_plain as attention_plain
from t2v_torch.kernels.fused_mha import fused_cross_mha, fused_self_mha

FLASH_MIN_KV = 512


def attention(q, k, v, scale: float | None = None):
    """(B, N, D) x (B, S, D) -> (B, N, D)."""
    if q.is_cuda and k.shape[1] >= FLASH_MIN_KV:
        return flash_attention(q, k, v, scale)
    return attention_plain(q, k, v, scale)


def attention_mh(q, k, v, scale: float | None = None):
    """Multi-head entry on (B, N, H, D) -> (B, N, H, D): fold the heads into
    the batch and dispatch through ``attention``."""
    b, n, h, d = q.shape
    s = k.shape[1]
    fold = lambda t, length: t.transpose(1, 2).reshape(b * h, length, d)
    out = attention(fold(q, n), fold(k, s), fold(v, s), scale)
    return out.reshape(b, h, n, d).transpose(1, 2)


def self_attention_packed(q, k, v, heads: int, scale: float | None = None):
    """Self-attention on (B, N, H·D) with the heads packed in the last
    axis, as the q/k/v projections emit them."""
    b, n, hd = q.shape
    if q.is_cuda and n < FLASH_MIN_KV:
        return fused_self_mha(q, k, v, heads, scale)
    unfold = lambda t: t.reshape(b, n, heads, hd // heads)
    return attention_mh(unfold(q), unfold(k), unfold(v), scale).reshape(b, n, hd)


def cross_attention_packed(q, k, v, heads: int, scale: float | None = None):
    """Cross-attention on (B, N, H·D) queries over a (B, S, H·D) context
    with the heads packed in the last axis. A caller whose context is shared
    by the frames of a sample merges the frame axis into N first."""
    b, n, hd = q.shape
    s = k.shape[1]
    if q.is_cuda and s < FLASH_MIN_KV:
        return fused_cross_mha(q, k, v, heads, scale)
    unfold = lambda t, length: t.reshape(b, length, heads, hd // heads)
    return attention_mh(unfold(q, n), unfold(k, s), unfold(v, s), scale).reshape(b, n, hd)
