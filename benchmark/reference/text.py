"""Plain float32 reference of the two text towers and their tokenisation.

* ``tokenize``: CLIP's byte-level BPE (the GPT-2 byte table, CLIP's split of
  lower-cased text into letter runs, single digits and runs of other
  characters, merges applied by rank) over a merge list built from the
  config's ``merge_words`` (each word merged left to right into one token).
  Ids: the 256 byte symbols, the same with ``</w>``, one id per merge, then
  start and end of text.
* ``modelscope_context``: the OpenCLIP ViT-H-14 tower as ModelScope runs
  it: one 77-token chunk (BOS, ids, EOS padding, ids after the first EOS
  set to 0), the penultimate block's output after ``ln_final``, and the
  A1111 emphasis of ``(word:w)``: the word's rows scaled by w and the whole
  chunk rescaled to its former mean.
* ``videocrafter_context``: the CLIP-L tower: BOS, ids, EOS padding to 77,
  the last block, ``final_layer_norm``, quick-GELU; no emphasis.
"""

from __future__ import annotations

import re
import unicodedata

import torch
import torch.nn.functional as F

from benchmark.reference import layers as L
from benchmark.reference.ops import Ops

CONTEXT = 77


def _byte_table() -> list[str]:
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    table = dict(zip(bs, (chr(c) for c in cs)))
    return [table[b] for b in sorted(table)], [table[b] for b in bs]


class Tokenizer:
    def __init__(self, merge_words: list[str]):
        by_byte, vocab_order = _byte_table()
        self.byte_sym = by_byte
        merges = []
        for w in merge_words:
            parts = list(w[:-1]) + [w[-1] + "</w>"]
            while len(parts) > 1:
                m = (parts[0], parts[1])
                if m not in merges:
                    merges.append(m)
                parts = ["".join(parts[:2])] + parts[2:]
        vocab = vocab_order + [v + "</w>" for v in vocab_order] + ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.ids = {tok: i for i, tok in enumerate(vocab)}
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.bos, self.eos = self.ids["<|startoftext|>"], self.ids["<|endoftext|>"]

    @staticmethod
    def words(text: str) -> list[str]:
        def kind(ch):
            c = unicodedata.category(ch)[0]
            return c if c in "LN" else ("S" if ch.isspace() else "O")
        out, i = [], 0
        text = re.sub(r"\s+", " ", text).strip().lower()
        while i < len(text):
            k = kind(text[i])
            if k == "S":
                i += 1
                continue
            j = i + 1
            if k != "N":
                while j < len(text) and kind(text[j]) == k:
                    j += 1
            out.append(text[i:j])
            i = j
        return out

    def _bpe(self, token: str) -> list[str]:
        word = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            pairs = [(self.ranks.get((a, b), 1 << 30), i) for i, (a, b) in enumerate(zip(word, word[1:]))]
            rank, _ = min(pairs)
            if rank == 1 << 30:
                break
            first, second = next(m for m, r in self.ranks.items() if r == rank)
            merged, i = [], 0
            while i < len(word):
                if i + 1 < len(word) and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        return word

    def encode(self, text: str) -> list[int]:
        ids = []
        for w in self.words(text):
            sym = "".join(self.byte_sym[b] for b in w.encode("utf-8"))
            ids += [self.ids[s] for s in self._bpe(sym)]
        return ids


def emphasis_segments(prompt: str) -> list[tuple[str, float]]:
    """The (text, weight) runs of a prompt whose only emphasis is
    ``(word:w)``."""
    out, pos = [], 0
    for m in re.finditer(r"\(([^():]+):([\d.]+)\)", prompt):
        if m.start() > pos:
            out.append((prompt[pos:m.start()], 1.0))
        out.append((m.group(1), float(m.group(2))))
        pos = m.end()
    if pos < len(prompt) or not out:
        out.append((prompt[pos:], 1.0))
    return out


def modelscope_chunk(tok: Tokenizer, prompt: str):
    """(ids, multipliers) of the one 77-token chunk of ``prompt``."""
    ids, mult = [], []
    for text, w in emphasis_segments(prompt):
        t = tok.encode(text)
        ids += t
        mult += [w] * len(t)
    if len(ids) > CONTEXT - 2:
        raise ValueError(f"prompt of {len(ids)} tokens does not fit one chunk: {prompt!r}")
    pad = CONTEXT - 1 - len(ids)
    return [tok.bos] + ids + [tok.eos] + [0] * (pad - 1), [1.0] + mult + [1.0] * pad


def openclip_shapes(cfg: dict):
    w, n = cfg["width"], cfg["layers"] - (1 if cfg["layer"] == "penultimate" else 0)
    out = [("token_embedding.weight", (cfg["vocab_size"], w)), ("positional_embedding", (CONTEXT, w))]
    for i in range(n):
        p = f"transformer.resblocks.{i}"
        out += [*L.norm_shapes(f"{p}.ln_1", w), (f"{p}.attn.in_proj_weight", (3 * w, w)),
                (f"{p}.attn.in_proj_bias", (3 * w,)), *L.linear_shapes(f"{p}.attn.out_proj", w, w),
                *L.norm_shapes(f"{p}.ln_2", w), *L.linear_shapes(f"{p}.mlp.c_fc", w, 4 * w),
                *L.linear_shapes(f"{p}.mlp.c_proj", 4 * w, w)]
    return out + L.norm_shapes("ln_final", w)


def hfclip_shapes(cfg: dict):
    w = cfg["width"]
    n = cfg["layers"] - (1 if cfg["layer"] == "penultimate" else 0)
    e = "text_model.embeddings"
    out = [(f"{e}.token_embedding.weight", (cfg["vocab_size"], w)),
           (f"{e}.position_embedding.weight", (CONTEXT, w))]
    for i in range(n):
        p = f"text_model.encoder.layers.{i}"
        out += [*L.norm_shapes(f"{p}.layer_norm1", w),
                *(s for q in ("q_proj", "k_proj", "v_proj", "out_proj")
                  for s in L.linear_shapes(f"{p}.self_attn.{q}", w, w)),
                *L.norm_shapes(f"{p}.layer_norm2", w), *L.linear_shapes(f"{p}.mlp.fc1", w, 4 * w),
                *L.linear_shapes(f"{p}.mlp.fc2", 4 * w, w)]
    return out + L.norm_shapes("text_model.final_layer_norm", w)


def _block(ops, x, heads, act, ln1, qkv, out_w, out_b, ln2, fc, proj, sd):
    b, s, w = x.shape
    dh = w // heads
    q, k, v = qkv(L.layer_norm(x, *ln1)).chunk(3, dim=-1)
    fold = lambda t: t.reshape(b, s, heads, dh).transpose(1, 2)
    scores = ops.matmul(fold(q), fold(k).transpose(-1, -2)) * dh ** -0.5
    mask = torch.full((s, s), float("-inf"), device=x.device).triu(1)
    o = ops.matmul(torch.softmax(scores + mask, dim=-1), fold(v)).transpose(1, 2).reshape(b, s, w)
    x = x + ops.linear(o, out_w, out_b)
    h = L.lin(ops, sd, fc, L.layer_norm(x, *ln2))
    h = h * torch.sigmoid(1.702 * h) if act == "quick_gelu" else F.gelu(h)
    return x + L.lin(ops, sd, proj, h)


def openclip_forward(sd, cfg: dict, tokens, ops: Ops | None = None):
    ops = ops or Ops()
    x = sd["token_embedding.weight"].float()[tokens] + sd["positional_embedding"].float()[None]
    n = cfg["layers"] - (1 if cfg["layer"] == "penultimate" else 0)
    for i in range(n):
        p = f"transformer.resblocks.{i}"
        qkv = lambda h, p=p: ops.linear(h, sd[f"{p}.attn.in_proj_weight"], sd[f"{p}.attn.in_proj_bias"])
        x = _block(ops, x, cfg["heads"], cfg["act"], (sd[f"{p}.ln_1.weight"], sd[f"{p}.ln_1.bias"]), qkv,
                   sd[f"{p}.attn.out_proj.weight"], sd[f"{p}.attn.out_proj.bias"],
                   (sd[f"{p}.ln_2.weight"], sd[f"{p}.ln_2.bias"]), f"{p}.mlp.c_fc", f"{p}.mlp.c_proj", sd)
    return L.ln(sd, "ln_final", x)


def hfclip_forward(sd, cfg: dict, tokens, ops: Ops | None = None):
    ops = ops or Ops()
    e = "text_model.embeddings"
    x = sd[f"{e}.token_embedding.weight"].float()[tokens] + sd[f"{e}.position_embedding.weight"].float()[None]
    n = cfg["layers"] - (1 if cfg["layer"] == "penultimate" else 0)
    for i in range(n):
        p = f"text_model.encoder.layers.{i}"
        a = f"{p}.self_attn"
        qkv = lambda h, a=a: torch.cat([L.lin(ops, sd, f"{a}.{q}", h) for q in ("q_proj", "k_proj", "v_proj")], -1)
        x = _block(ops, x, cfg["heads"], cfg["act"], (sd[f"{p}.layer_norm1.weight"], sd[f"{p}.layer_norm1.bias"]),
                   qkv, sd[f"{a}.out_proj.weight"], sd[f"{a}.out_proj.bias"],
                   (sd[f"{p}.layer_norm2.weight"], sd[f"{p}.layer_norm2.bias"]), f"{p}.mlp.fc1", f"{p}.mlp.fc2", sd)
    return L.ln(sd, "text_model.final_layer_norm", x)


def modelscope_context(sd, cfg: dict, tok: Tokenizer, prompt: str, ops: Ops | None = None):
    """(1, 77, width) conditioning of one ModelScope prompt."""
    ids, mult = modelscope_chunk(tok, prompt)
    dev = sd["positional_embedding"].device
    z = openclip_forward(sd, cfg, torch.tensor([ids], device=dev), ops)
    m = torch.tensor(mult, device=dev)[None, :, None]
    mean = z.mean()
    z = z * m
    return z * (mean / z.mean())


def videocrafter_context(sd, cfg: dict, tok: Tokenizer, prompt: str, ops: Ops | None = None):
    """(1, 77, width) conditioning of one VideoCrafter prompt."""
    ids = tok.encode(prompt)[: CONTEXT - 2]
    row = [tok.bos] + ids + [tok.eos] * (CONTEXT - 1 - len(ids))
    dev = sd["text_model.embeddings.position_embedding.weight"].device
    return hfclip_forward(sd, cfg, torch.tensor([row], device=dev), ops)
