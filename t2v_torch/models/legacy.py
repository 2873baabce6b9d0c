"""Legacy 2-D UNet blocks of the reference's model zoo, in PyTorch.

The port of the JAX package's ``models/legacy.py``: ``resample``,
``LegacyResidualBlock`` and ``LegacyAttentionBlock``, the image-UNet
vocabulary that UNetSD grew out of. No published config reaches them; they
are part of the reference's module surface, for models composed from that
vocabulary.

Layouts and numerics are those of the rest of ``t2v_torch.models``:
channels-last ``(B, H, W, C)`` tensors, convolutions on the NCHW view of
that memory, GroupNorm statistics and softmax in float32. Parameters carry
the JAX modules' names (``norm1``, ``conv1``, ``embedding``, ``norm2``,
``conv2``, ``shortcut``; ``norm``, ``to_qkv``, ``context_kv``, ``proj``) in
torch layouts; ``io/convert.py::from_jax_legacy`` carries flax weights
over. The parity quirks are kept:

  * the reference scales q and k by d^-0.25 each; the attention applies the
    product, one 1/sqrt(d), to q through the dispatch
    (``kernels/attention.py::attention_mh``: the flash kernel where it
    takes the shapes, its plain version elsewhere);
  * context k/v rows come *before* the spatial keys;
  * the closing conv of the residual block and the attention's output
    projection are zero-initialised;
  * ``resample``'s downsample is the reference's adaptive average pool to
    half size, a 2x2 mean pool at the even sizes it is given.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from t2v_torch.kernels.attention import attention_mh
from t2v_torch.models.blocks import Conv2d, GroupNorm32


def resample(x: torch.Tensor, mode: str, reference_hw=None) -> torch.Tensor:
    """'none' | 'upsample' (nearest, to ``reference_hw``) | 'downsample'
    (2x average pool). x: (B, H, W, C)."""
    if mode == "none":
        return x
    b, h, w, c = x.shape
    if mode == "upsample":
        if reference_hw is None:
            raise ValueError("upsample mode needs the reference (H, W)")
        rh, rw = reference_hw
        iy = torch.arange(rh, device=x.device) * h // rh
        ix = torch.arange(rw, device=x.device) * w // rw
        return x[:, iy][:, :, ix]
    if mode == "downsample":
        if h % 2 or w % 2:
            raise ValueError("downsample expects even spatial dims")
        return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
    raise ValueError(f"unknown resample mode {mode!r}")


def _zero(module: nn.Module) -> nn.Module:
    with torch.no_grad():
        for p in module.parameters():
            p.zero_()
    return module


class LegacyResidualBlock(nn.Module):
    """GN -> SiLU -> 3x3 conv twice, with the timestep embedding as a
    scale and shift of the second norm (or added before it), and the
    block's resampling in the middle. Input (B, H, W, C), embedding (B, E);
    ``reference_hw`` sizes the 'upsample' mode."""

    def __init__(self, in_dim: int, embed_dim: int, out_dim: int,
                 use_scale_shift_norm: bool = True, mode: str = "none"):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.mode = mode
        self.norm1 = GroupNorm32(in_dim, silu=True)
        self.conv1 = Conv2d(in_dim, out_dim, 3, padding=1)
        self.embedding = nn.Linear(embed_dim, out_dim * 2 if use_scale_shift_norm else out_dim)
        self.norm2 = GroupNorm32(out_dim, silu=not use_scale_shift_norm)
        self.conv2 = _zero(Conv2d(out_dim, out_dim, 3, padding=1))
        self.shortcut = Conv2d(in_dim, out_dim, 1) if in_dim != out_dim else None

    def forward(self, x, e, reference_hw=None):
        identity = resample(x, self.mode, reference_hw)
        h = self.conv1(resample(self.norm1(x), self.mode, reference_hw))
        emb = self.embedding(F.silu(e.float()).to(x.dtype))[:, None, None, :]
        if self.use_scale_shift_norm:
            scale, shift = emb.chunk(2, dim=-1)
            h = self.conv2(F.silu(self.norm2(h) * (1.0 + scale) + shift))
        else:
            h = self.conv2(self.norm2(h + emb))
        if self.shortcut is not None:
            identity = self.shortcut(identity)
        return h + identity


class LegacyAttentionBlock(nn.Module):
    """Spatial self-attention over the H·W tokens, with optional context
    k/v rows prepended to the keys. Input (B, H, W, C), context (B, L, Cc).
    ``head_dim``, when given, sets the head count (dim // head_dim) over
    ``num_heads``."""

    def __init__(self, dim: int, context_dim: int | None = None, num_heads: int | None = None,
                 head_dim: int | None = None):
        super().__init__()
        self.heads = dim // head_dim if head_dim else num_heads
        self.dim_head = dim // self.heads
        if self.heads * self.dim_head != dim:
            raise ValueError("num_heads * head_dim must equal dim")
        self.norm = GroupNorm32(dim)
        self.to_qkv = nn.Linear(dim, dim * 3)
        self.context_kv = nn.Linear(context_dim, dim * 2) if context_dim else None
        self.proj = _zero(nn.Linear(dim, dim))

    def forward(self, x, context=None):
        b, h, w, c = x.shape
        n, d = self.heads, self.dim_head
        # q | k | v thirds on the channel axis, each head-major
        q, k, v = self.to_qkv(self.norm(x).reshape(b, h * w, c)).reshape(b, h * w, 3, n, d).unbind(2)
        if context is not None:
            ck, cv = self.context_kv(context.to(x.dtype)).reshape(b, -1, 2, n, d).unbind(2)
            k = torch.cat([ck, k], dim=1)  # context rows first
            v = torch.cat([cv, v], dim=1)
        out = attention_mh(q.contiguous(), k.contiguous(), v.contiguous(), scale=d ** -0.5)
        return self.proj(out.reshape(b, h, w, c)) + x
