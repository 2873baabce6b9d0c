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
  CPU tensors take the plain path;
* ``temporal_attention_packed`` on sample-major (B·F, N, H·D), attention
  across the F frame rows of each sample: on a CUDA tensor F <
  ``FLASH_MIN_KV`` goes to the frame-axis kernel; longer frame axes and CPU
  tensors swap the frame and token axes and take ``self_attention_packed``.
  No model calls it (the JAX package's models do not either: its
  ``TemporalTransformer`` transposes once and runs ``self_attention_packed``,
  which measured faster on the TPU).

Every entry is differentiable: a CUDA tensor that needs a gradient runs the
same kernel as the forward of its ``torch.autograd.Function`` (flash
attention's backward is the two backward kernels, the packed kernels'
recomputes through the plain math); tensors that need none launch what they
always launched.
"""

from __future__ import annotations

from t2v_torch.kernels.flash_attention import flash_attention
from t2v_torch.kernels.flash_attention import flash_attention_plain as attention_plain
from t2v_torch.kernels.fused_mha import fused_cross_mha, fused_self_mha, fused_temporal_mha
from t2v_torch.kernels.fused_mha import swap_frame_axis as _swap_frame_axis
from t2v_torch.kernels.fused_mha import unswap_frame_axis as _unswap_frame_axis

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


def temporal_attention_packed(q, k, v, heads: int, f: int, scale: float | None = None):
    """Self-attention across the frame axis of sample-major (B·F, N, H·D)
    tensors, staying in the spatial token layout: rows i·F .. (i+1)·F - 1
    are sample i's frames, and every spatial token and head attends across
    them."""
    n = q.shape[1]
    if q.is_cuda and f < FLASH_MIN_KV:
        return fused_temporal_mha(q, k, v, heads, f, scale)
    swap = lambda t: _swap_frame_axis(t, f)
    return _unswap_frame_axis(self_attention_packed(swap(q), swap(k), swap(v), heads, scale), n)
