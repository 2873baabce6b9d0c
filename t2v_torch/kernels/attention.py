"""Attention dispatch of the port, as in the JAX package's
``kernels/attention.py``. A tensor goes to a kernel only when it lies on
the card and the kernel takes what the model asked for: bf16, and a head
dim of the kernel's set (``flash_takes``, ``packed_takes``,
``relpos_takes``, one predicate per route). Every other tensor (a float32
or float16 model on the card, any tensor on the CPU) takes the plain
version, on its own device; this is routing by the model's dtype and
shape, as the JAX dispatch takes XLA off the TPU and for head dims its
kernel refuses, and the kernel wrappers still raise on what they refuse.

* ``attention`` on head-folded (B, N, D): a key length >= ``FLASH_MIN_KV``
  goes to the flash kernel; shorter keys (the 77-token cross-attention,
  which the JAX package also leaves to plain XLA math) go to
  ``attention_plain``;
* ``self_attention_packed`` on packed heads (B, N, H·D): N <
  ``FLASH_MIN_KV`` goes to the packed short-sequence kernel and longer
  sequences are folded and go through ``attention``;
* ``cross_attention_packed`` on packed heads, q (B, N, H·D) over a shared
  context k/v (B, S, H·D): S < ``FLASH_MIN_KV`` goes to the packed kernel's
  cross entry, longer contexts fold and go through ``attention``;
* ``temporal_attention_packed`` on sample-major (B·F, N, H·D), attention
  across the F frame rows of each sample: F < ``FLASH_MIN_KV`` goes to the
  frame-axis kernel; otherwise the frame and token axes are swapped and
  ``self_attention_packed`` takes it. No model calls it (the JAX package's
  models do not either: its ``TemporalTransformer`` transposes once and
  runs ``self_attention_packed``, which measured faster on the TPU);
* ``relpos_attention``, VideoCrafter's temporal attention with
  relative-position biases in the resident (B·T, N, H·D) layout: the
  rel-pos kernel, or ``relpos_mha_plain``.

Every entry is differentiable: a CUDA tensor that needs a gradient runs the
same kernel as the forward of its ``torch.autograd.Function`` (flash
attention's backward is the two backward kernels, the packed kernels'
recomputes through the plain math); tensors that need none launch what they
always launched.
"""

from __future__ import annotations

import torch

from t2v_torch.kernels import _build
from t2v_torch.kernels.flash_attention import SUPPORTED_D, flash_attention
from t2v_torch.kernels.flash_attention import flash_attention_plain as attention_plain
from t2v_torch.kernels.fused_mha import HEAD_DIMS, fused_cross_mha, fused_self_mha
from t2v_torch.kernels.fused_mha import fused_temporal_mha
from t2v_torch.kernels.fused_mha import swap_frame_axis as _swap_frame_axis
from t2v_torch.kernels.fused_mha import unswap_frame_axis as _unswap_frame_axis
from t2v_torch.kernels.relpos_mha import MAX_D as RELPOS_MAX_D
from t2v_torch.kernels.relpos_mha import relpos_mha, relpos_mha_plain

FLASH_MIN_KV = 512


def flash_takes(q) -> bool:
    """Whether the flash kernel takes head-folded (B, N, D) ``q``."""
    return _build.on_card(q) and q.dtype == torch.bfloat16 and q.shape[-1] in SUPPORTED_D


def packed_takes(q, heads: int) -> bool:
    """Whether the packed kernels take (rows, N, H·D) ``q`` of ``heads``
    heads."""
    hd = q.shape[-1]
    return (_build.on_card(q) and q.dtype == torch.bfloat16 and hd % heads == 0
            and hd // heads in HEAD_DIMS)


def relpos_takes(q, heads: int) -> bool:
    """Whether the rel-pos kernel takes (B·T, N, H·D) ``q`` of ``heads``
    heads (a head dim that is a multiple of 8 up to ``relpos_mha.MAX_D``)."""
    hd = q.shape[-1]
    return (_build.on_card(q) and q.dtype == torch.bfloat16 and hd % heads == 0
            and (hd // heads) % 8 == 0 and hd // heads <= RELPOS_MAX_D)


def attention(q, k, v, scale: float | None = None):
    """(B, N, D) x (B, S, D) -> (B, N, D)."""
    if k.shape[1] >= FLASH_MIN_KV and flash_takes(q):
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
    if n < FLASH_MIN_KV and packed_takes(q, heads):
        return fused_self_mha(q, k, v, heads, scale)
    unfold = lambda t: t.reshape(b, n, heads, hd // heads)
    return attention_mh(unfold(q), unfold(k), unfold(v), scale).reshape(b, n, hd)


def cross_attention_packed(q, k, v, heads: int, scale: float | None = None):
    """Cross-attention on (B, N, H·D) queries over a (B, S, H·D) context
    with the heads packed in the last axis. A caller whose context is shared
    by the frames of a sample merges the frame axis into N first."""
    b, n, hd = q.shape
    s = k.shape[1]
    if s < FLASH_MIN_KV and packed_takes(q, heads):
        return fused_cross_mha(q, k, v, heads, scale)
    unfold = lambda t, length: t.reshape(b, length, heads, hd // heads)
    return attention_mh(unfold(q, n), unfold(k, s), unfold(v, s), scale).reshape(b, n, hd)


def temporal_attention_packed(q, k, v, heads: int, f: int, scale: float | None = None):
    """Self-attention across the frame axis of sample-major (B·F, N, H·D)
    tensors, staying in the spatial token layout: rows i·F .. (i+1)·F - 1
    are sample i's frames, and every spatial token and head attends across
    them."""
    n = q.shape[1]
    if f < FLASH_MIN_KV and packed_takes(q, heads):
        return fused_temporal_mha(q, k, v, heads, f, scale)
    swap = lambda t: _swap_frame_axis(t, f)
    return _unswap_frame_axis(self_attention_packed(swap(q), swap(k), swap(v), heads, scale), n)


def relpos_attention(q, k, v, k2, v2, heads: int, frame_split: int,
                     scale: float | None = None):
    """Temporal attention with relative-position biases (``relpos_mha``'s
    contract) on sample-major (B·T, N, H·D)."""
    if relpos_takes(q, heads):
        return relpos_mha(q, k, v, k2, v2, heads, frame_split, scale)
    return relpos_mha_plain(q, k, v, k2, v2, heads, frame_split, scale)
