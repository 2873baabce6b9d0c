"""OpenCLIP text transformer in PyTorch (ModelScope: ViT-H-14, width 1024,
16 heads, penultimate layer, then ``ln_final``).

The port of the JAX package's ``text/clip.py``. "Penultimate" is
structural: a tower of ``layers`` blocks keeps ``layers - 1`` of them.
Parameters carry the open_clip state-dict names (``token_embedding.weight``,
``positional_embedding``, ``transformer.resblocks.{i}.attn.in_proj_weight``,
``ln_final.weight`` …). LayerNorm and the softmax are float32; the causal
mask is additive. The 77-token attention is plain PyTorch math, as the
JAX package leaves it to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from t2v_torch.core.config import CLIPTextConfig
from t2v_torch.models.blocks import LayerNorm32


class _MultiheadAttention(nn.Module):
    """Holds ``in_proj_weight`` / ``in_proj_bias`` / ``out_proj`` under
    torch.nn.MultiheadAttention's names."""

    def __init__(self, width: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)


class _MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.ln_1 = LayerNorm32(cfg.width)
        self.attn = _MultiheadAttention(cfg.width)
        self.ln_2 = LayerNorm32(cfg.width)
        self.mlp = _MLP(cfg.width)

    def forward(self, x, mask):
        cfg = self.cfg
        b, s, width = x.shape
        head_dim = width // cfg.heads
        h = self.ln_1(x)
        qkv = F.linear(h, self.attn.in_proj_weight, self.attn.in_proj_bias)
        fold = lambda t: t.reshape(b, s, cfg.heads, head_dim).transpose(1, 2)
        q, k, v = (fold(t) for t in qkv.chunk(3, dim=-1))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (head_dim ** -0.5)
        attn = torch.softmax(scores + mask, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, s, width)
        x = x + self.attn.out_proj(out)
        h = self.mlp.c_fc(self.ln_2(x))
        if cfg.act == "quick_gelu":
            h = h * torch.sigmoid(1.702 * h)
        else:
            h = F.gelu(h.float()).to(h.dtype)
        return x + self.mlp.c_proj(h)


class _Transformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, n_layers: int):
        super().__init__()
        self.resblocks = nn.ModuleList([ResidualAttentionBlock(cfg) for _ in range(n_layers)])


class CLIPTextTransformer(nn.Module):
    """forward(tokens (B, 77) int) -> (B, 77, width) hidden states after
    ``ln_final`` at the configured depth."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, cfg.width))
        self.transformer = _Transformer(cfg, self.effective_layers)
        self.ln_final = LayerNorm32(cfg.width)

    @property
    def effective_layers(self) -> int:
        return self.cfg.layers - (1 if self.cfg.layer == "penultimate" else 0)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.token_embedding(tokens)
        s = x.shape[1]
        x = x + self.positional_embedding[None, :s].to(x.dtype)
        mask = torch.full((s, s), float("-inf"), device=x.device).triu(1)
        for block in self.transformer.resblocks:
            x = block(x, mask)
        return self.ln_final(x)
