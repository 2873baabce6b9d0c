"""Mixed-precision policy of the port: bf16 weights and compute with f32
normalisation statistics and softmax (``Policy.bf16``), or fp32 throughout
for parity tests (``Policy.fp32``)."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Policy:
    """param_dtype: dtype of the weights, and so of the activations: each
    model casts its input to its weights' dtype."""

    param_dtype: torch.dtype = torch.float32

    @classmethod
    def bf16(cls) -> "Policy":
        return cls(param_dtype=torch.bfloat16)

    @classmethod
    def fp32(cls) -> "Policy":
        return cls()
