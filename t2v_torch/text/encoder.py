"""Text conditioning: prompt -> per-step cond tables, in PyTorch.

The port of the JAX package's ``text/encoder.py``: tokenizer, emphasis
parser, 75-token chunker, the CLIP tower, the A1111 multiplier renorm and
multi-chunk concatenation, plus prompt-editing schedules resolved ahead of
time into stacked cond tables that the sampler indexes per step
(``diffusion/sampling.py::_cond_at``). Textual-inversion embeddings are
not part of the port yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from t2v_torch.text import chunking
from t2v_torch.text.clip import CLIPTextTransformer
from t2v_torch.text.schedule import parse_prompt_schedule
from t2v_torch.text.tokenizer import CLIPTokenizer


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
        self._cache: dict[tuple, torch.Tensor] = {}

    def invalidate_cache(self) -> None:
        """Drop cached line encodings (after the tower's weights change)."""
        self._cache.clear()

    @property
    def device(self) -> torch.device:
        return self.model.positional_embedding.device

    @torch.no_grad()
    def _encode_chunk(self, tokens: np.ndarray, multipliers: np.ndarray) -> torch.Tensor:
        """One (1, 77) chunk through the tower + weight renorm. The ids after
        the first EOS are 0 (the SD2 padding of the OpenCLIP tower)."""
        tokens = chunking.pad_after_eos(tokens, self.tokenizer.eos_id, 0)
        dev = self.device
        z = self.model(torch.as_tensor(tokens, dtype=torch.long, device=dev))
        return weight_renorm(z, torch.as_tensor(multipliers, dtype=torch.float32, device=dev))

    def encode_line(self, line: str) -> torch.Tensor:
        """(77*chunks, D) embedding of one prompt line, cached."""
        key = (line, self.comma_backtrack, self.enable_emphasis)
        if key in self._cache:
            return self._cache[key]
        if len(self._cache) >= 256:  # bound a long-running server's memory
            self._cache.pop(next(iter(self._cache)))
        chunks, _ = chunking.tokenize_line(
            line, self.tokenizer, enable_emphasis=self.enable_emphasis,
            comma_backtrack=self.comma_backtrack,
        )
        out = torch.cat([
            self._encode_chunk(np.asarray([ch.tokens], np.int64),
                               np.asarray([ch.multipliers], np.float32))[0]
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
