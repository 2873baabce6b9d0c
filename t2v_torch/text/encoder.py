"""Text conditioning: prompt -> per-step cond tables, in PyTorch.

The port of the JAX package's ``text/encoder.py``: tokenizer, emphasis
parser, 75-token chunker, the CLIP tower, the A1111 multiplier renorm and
multi-chunk concatenation, plus prompt-editing schedules resolved ahead of
time into stacked cond tables that the sampler indexes per step
(``diffusion/sampling.py::_cond_at``). ``EmbeddingDB`` holds
textual-inversion embeddings (A1111 files); a prompt naming one gets its
rows spliced into the token embeddings before the transformer.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from t2v_torch.text import chunking
from t2v_torch.text.clip import CLIPTextTransformer
from t2v_torch.text.schedule import parse_prompt_schedule
from t2v_torch.text.tokenizer import CLIPTokenizer


class EmbeddingDB:
    """Textual-inversion embedding lookup. Embeddings register by name;
    during chunking, a token run matching a name's tokenization is replaced
    by the embedding matrix's rows."""

    def __init__(self, tokenizer: CLIPTokenizer):
        self.tokenizer = tokenizer
        self._by_first_token: dict[int, list[tuple[list[int], np.ndarray]]] = {}
        self.version = 0  # bumped on registration; keys the encoder's line cache

    def register(self, name: str, vectors: np.ndarray) -> None:
        ids = self.tokenizer.encode(name)
        self._by_first_token.setdefault(ids[0], []).append((ids, vectors))
        self.version += 1

    def find(self, tokens: list[int], position: int):
        """(matrix, ids consumed) of the longest registered name starting at
        ``tokens[position]``, or (None, 0)."""
        best = None
        for ids, vec in self._by_first_token.get(tokens[position], []):
            if tokens[position : position + len(ids)] == ids:
                if best is None or len(ids) > len(best[0]):
                    best = (ids, vec)
        if best is None:
            return None, 0
        return best[1], len(best[0])

    def __bool__(self) -> bool:
        return bool(self._by_first_token)

    def register_file(self, path: str, name: str | None = None) -> str:
        """Register an A1111 textual-inversion file under its file name (or
        ``name``). Layouts: ``{'string_to_param': {'*': T}}``, ``{'emb_params':
        T}`` or a single tensor, in ``.pt`` / ``.bin`` (read weights-only) or
        ``.safetensors``."""
        if path.endswith(".safetensors"):
            from t2v_torch.io.safetensors_io import load_safetensors

            sd, _ = load_safetensors(path)
        else:
            from t2v_torch.io.convert import load_torch_checkpoint

            sd = load_torch_checkpoint(path)
        vec = None
        if "string_to_param" in sd:
            p = sd["string_to_param"]
            vec = p.get("*") if hasattr(p, "get") else None
            if vec is None and hasattr(p, "values"):
                vec = next(iter(p.values()))
        elif "emb_params" in sd:
            vec = sd["emb_params"]
        else:
            tensors = [v for v in sd.values() if hasattr(v, "ndim")]
            if len(tensors) == 1:
                vec = tensors[0]
        if vec is None:
            raise ValueError(f"unrecognised embedding file layout: {path}")
        vec = vec.detach().float().numpy() if torch.is_tensor(vec) else np.asarray(vec, np.float32)
        if vec.ndim == 1:
            vec = vec[None]
        name = name or os.path.splitext(os.path.basename(path))[0]
        self.register(name, vec)
        return name

    def load_dir(self, emb_dir: str) -> list[str]:
        """Register every ``.pt`` / ``.bin`` / ``.safetensors`` file of a
        directory (A1111's embeddings-dir); returns the registered names.
        A file of another layout is reported and skipped, as A1111 does."""
        names = []
        if not os.path.isdir(emb_dir):
            return names
        for fn in sorted(os.listdir(emb_dir)):
            if fn.endswith((".pt", ".bin", ".safetensors")):
                try:
                    names.append(self.register_file(os.path.join(emb_dir, fn)))
                except Exception as e:
                    print(f"t2v_torch: skipping embedding {fn}: {e}")
        return names


@dataclass
class Conditioning:
    """cond / uncond: (1, L, D) tensors, or (S, 1, L, D) with one row per
    sampling step when the prompt is scheduled."""

    cond: torch.Tensor
    uncond: torch.Tensor


def weight_renorm(z: torch.Tensor, mult: torch.Tensor) -> torch.Tensor:
    """A1111 emphasis renorm: scale token rows by their multipliers, then
    restore the pre-scale mean."""
    m = mult[..., None].to(z.dtype)
    original_mean = z.mean()
    z = z * m
    return z * (original_mean / z.mean())


class TextEncoder:
    """``comma_backtrack`` and ``enable_emphasis`` are the request's
    settings; the pipeline sets them before each ``encode_request``."""

    def __init__(self, model: CLIPTextTransformer, tokenizer: CLIPTokenizer):
        self.model = model
        self.tokenizer = tokenizer
        self.comma_backtrack = chunking.DEFAULT_COMMA_BACKTRACK
        self.enable_emphasis = True
        self.embedding_db = EmbeddingDB(tokenizer)
        self._cache: dict[tuple, torch.Tensor] = {}

    def invalidate_cache(self) -> None:
        """Drop cached line encodings (after the tower's weights change)."""
        self._cache.clear()

    @property
    def device(self) -> torch.device:
        return self.model.positional_embedding.device

    @torch.no_grad()
    def _encode_chunk(self, tokens: np.ndarray, multipliers: np.ndarray, fixes=()) -> torch.Tensor:
        """One (1, 77) chunk through the tower + weight renorm. The ids after
        the first EOS are 0 (the SD2 padding of the OpenCLIP tower).
        ``fixes`` holds the chunk's (position, matrix) textual-inversion
        splices."""
        tokens = chunking.pad_after_eos(tokens, self.tokenizer.eos_id, 0)
        dev = self.device
        ids = torch.as_tensor(tokens, dtype=torch.long, device=dev)
        emb = self._spliced_embeddings(ids, fixes) if fixes else None
        z = self.model(ids, input_embeddings=emb)
        return weight_renorm(z, torch.as_tensor(multipliers, dtype=torch.float32, device=dev))

    def _spliced_embeddings(self, ids: torch.Tensor, fixes) -> torch.Tensor:
        """The token embeddings of a (1, 77) chunk with each fix's rows in
        place of its placeholder ids. A fix's position counts from the first
        id after BOS, hence the +1; rows past the chunk's end are dropped."""
        x = self.model.token_embedding_weight[ids].clone()
        for pos, vec in fixes:
            n = min(vec.shape[0], x.shape[1] - (pos + 1))
            x[0, pos + 1 : pos + 1 + n] = torch.as_tensor(vec[:n], dtype=x.dtype, device=x.device)
        return x

    def encode_line(self, line: str) -> torch.Tensor:
        """(77*chunks, D) embedding of one prompt line, cached; the key holds
        the embedding db's version, so a later registration is seen."""
        key = (line, self.comma_backtrack, self.enable_emphasis, self.embedding_db.version)
        if key in self._cache:
            return self._cache[key]
        if len(self._cache) >= 256:  # bound a long-running server's memory
            self._cache.pop(next(iter(self._cache)))
        chunks, _ = chunking.tokenize_line(
            line, self.tokenizer, enable_emphasis=self.enable_emphasis,
            comma_backtrack=self.comma_backtrack,
            embedding_db=self.embedding_db.find if self.embedding_db else None,
        )
        out = torch.cat([
            self._encode_chunk(np.asarray([ch.tokens], np.int64),
                               np.asarray([ch.multipliers], np.float32), ch.fixes)[0]
            for ch in chunks
        ], dim=0)
        self._cache[key] = out
        return out

    def encode_request(self, prompt: str, n_prompt: str, steps: int) -> Conditioning:
        """Request conditioning with prompt-editing support: static prompts
        give (1, L, D), scheduled ones (S, 1, L, D) with one row per step."""
        sched_c = parse_prompt_schedule(prompt, steps)
        sched_uc = parse_prompt_schedule(n_prompt, steps)
        zs_c = [self.encode_line(p) for p in sched_c.prompts]
        zs_uc = [self.encode_line(p) for p in sched_uc.prompts]

        # chunk-count alignment: pad the shorter side with empty-chunk
        # encodings so fused CFG can concatenate the pair
        max_len = max(z.shape[0] for z in zs_c + zs_uc)

        def pad(z: torch.Tensor) -> torch.Tensor:
            if z.shape[0] == max_len:
                return z
            empty = self.encode_line("")
            reps = (max_len - z.shape[0]) // empty.shape[0]
            return torch.cat([z] + [empty] * reps, dim=0)

        zs_c = [pad(z) for z in zs_c]
        zs_uc = [pad(z) for z in zs_uc]
        if sched_c.is_static and sched_uc.is_static:
            return Conditioning(cond=zs_c[0][None], uncond=zs_uc[0][None])
        cond = torch.stack([zs_c[i] for i in sched_c.index])[:, None]
        uncond = torch.stack([zs_uc[i] for i in sched_uc.index])[:, None]
        return Conditioning(cond=cond, uncond=uncond)
