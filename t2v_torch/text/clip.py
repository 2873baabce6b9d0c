"""CLIP text transformers in PyTorch: the OpenCLIP tower (ModelScope:
ViT-H-14, width 1024, 16 heads, penultimate layer, then ``ln_final``) and
the Hugging Face CLIP-L tower (VideoCrafter: width 768, 12 layers,
quick-GELU, last hidden state), ``HFCLIPTextModel``, which computes the
same function under the HF state-dict names (``text_model.embeddings.*``,
``text_model.encoder.layers.{i}.self_attn.q_proj`` …).

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


def _attention_block(x, mask, heads: int, act: str, ln_1, qkv, out_proj, ln_2, fc, proj):
    """One pre-LN residual block on (B, S, width): causal multi-head
    attention with an f32 softmax, then the MLP. ``qkv`` maps the normed
    input to the packed (B, S, 3*width) projection."""
    b, s, width = x.shape
    head_dim = width // heads
    fold = lambda t: t.reshape(b, s, heads, head_dim).transpose(1, 2)
    q, k, v = (fold(t) for t in qkv(ln_1(x)).chunk(3, dim=-1))
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (head_dim ** -0.5)
    attn = torch.softmax(scores + mask, dim=-1).to(v.dtype)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(b, s, width)
    x = x + out_proj(out)
    h = fc(ln_2(x))
    if act == "quick_gelu":
        h = h * torch.sigmoid(1.702 * h)
    else:
        h = F.gelu(h.float()).to(h.dtype)
    return x + proj(h)


def _causal_mask(s: int, device) -> torch.Tensor:
    return torch.full((s, s), float("-inf"), device=device).triu(1)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.ln_1 = LayerNorm32(cfg.width)
        self.attn = _MultiheadAttention(cfg.width)
        self.ln_2 = LayerNorm32(cfg.width)
        self.mlp = _MLP(cfg.width)

    def forward(self, x, mask):
        qkv = lambda h: F.linear(h, self.attn.in_proj_weight, self.attn.in_proj_bias)
        return _attention_block(x, mask, self.cfg.heads, self.cfg.act, self.ln_1, qkv,
                                self.attn.out_proj, self.ln_2, self.mlp.c_fc, self.mlp.c_proj)


class _Transformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, n_layers: int):
        super().__init__()
        self.resblocks = nn.ModuleList([ResidualAttentionBlock(cfg) for _ in range(n_layers)])


class CLIPTextTransformer(nn.Module):
    """forward(tokens (B, 77) int) -> (B, 77, width) hidden states after
    ``ln_final`` at the configured depth. ``input_embeddings`` (B, 77,
    width) replaces the token lookup: the textual-inversion path, where the
    caller spliced embedding rows into the looked-up ones."""

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

    @property
    def token_embedding_weight(self) -> torch.Tensor:
        return self.token_embedding.weight

    def forward(self, tokens: torch.Tensor, input_embeddings: torch.Tensor | None = None) -> torch.Tensor:
        x = self.token_embedding(tokens) if input_embeddings is None else input_embeddings
        s = x.shape[1]
        x = x + self.positional_embedding[None, :s].to(x.dtype)
        mask = _causal_mask(s, x.device)
        for block in self.transformer.resblocks:
            x = block(x, mask)
        return self.ln_final(x)


class _HFSelfAttention(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)


class _HFMLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.fc1 = nn.Linear(width, 4 * width)
        self.fc2 = nn.Linear(4 * width, width)


class _HFEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.layer_norm1 = LayerNorm32(cfg.width)
        self.self_attn = _HFSelfAttention(cfg.width)
        self.layer_norm2 = LayerNorm32(cfg.width)
        self.mlp = _HFMLP(cfg.width)

    def forward(self, x, mask):
        a = self.self_attn
        qkv = lambda h: torch.cat([a.q_proj(h), a.k_proj(h), a.v_proj(h)], dim=-1)
        return _attention_block(x, mask, self.cfg.heads, self.cfg.act, self.layer_norm1, qkv,
                                a.out_proj, self.layer_norm2, self.mlp.fc1, self.mlp.fc2)


class _HFEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.position_embedding = nn.Embedding(cfg.context_length, cfg.width)


class _HFEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, n_layers: int):
        super().__init__()
        self.layers = nn.ModuleList([_HFEncoderLayer(cfg) for _ in range(n_layers)])


class _HFTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, n_layers: int):
        super().__init__()
        self.embeddings = _HFEmbeddings(cfg)
        self.encoder = _HFEncoder(cfg, n_layers)
        self.final_layer_norm = LayerNorm32(cfg.width)


class HFCLIPTextModel(nn.Module):
    """forward(tokens (B, 77) int) -> (B, 77, width): the last hidden state
    after ``final_layer_norm`` (a "penultimate" config keeps one block
    fewer, as the OpenCLIP tower does). ``input_embeddings`` as in
    ``CLIPTextTransformer``."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        n_layers = cfg.layers - (1 if cfg.layer == "penultimate" else 0)
        self.text_model = _HFTextModel(cfg, n_layers)

    @property
    def token_embedding_weight(self) -> torch.Tensor:
        return self.text_model.embeddings.token_embedding.weight

    def forward(self, tokens: torch.Tensor, input_embeddings: torch.Tensor | None = None) -> torch.Tensor:
        tm = self.text_model
        x = tm.embeddings.token_embedding(tokens) if input_embeddings is None else input_embeddings
        s = x.shape[1]
        x = x + tm.embeddings.position_embedding.weight[None, :s].to(x.dtype)
        mask = _causal_mask(s, x.device)
        for layer in tm.encoder.layers:
            x = layer(x, mask)
        return tm.final_layer_norm(x)
