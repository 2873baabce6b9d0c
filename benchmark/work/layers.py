"""Operations and bytes of one call of a layer, from its shapes.

The least time of a call is max(FLOPs / peak FLOP/s, bytes / peak bytes/s)
with every input read once and every output written once (the Bound column
of the port's kernel table in PERF.md): whatever implements the layer, it
cannot take less. Matrix products count 2 operations a multiply-add;
element-wise work is not counted.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Work:
    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    def least_s(self, peaks: dict) -> float:
        return max(self.flops / peaks["flops"], self.bytes / peaks["bytes_per_s"])


def attention(rows: int, n: int, dq: int, heads: int, dh: int, *, ctx_rows: int = 0,
              s: int = 0, dc: int = 0, frames: int = 0, itemsize: int = 2) -> Work:
    """One attention module: q/k/v projections (no bias), the attention
    core, the output projection (with bias).

    rows x n tokens of width dq. Self attention over the n tokens of a row
    (s = 0); cross attention over ``ctx_rows`` x s context tokens of width
    dc, each context row shared by rows / ctx_rows token rows; temporal
    attention (``frames`` = t > 0) over groups of t rows that share a token
    position, with relative-position key and value terms (t, t, dh)."""
    inner = heads * dh
    tokens = rows * n
    if s:
        kv_tokens, kv_width = ctx_rows * s, dc
        core = 4 * tokens * s * inner
    elif frames:
        kv_tokens, kv_width = tokens, dq
        core = 8 * tokens * frames * inner
    else:
        kv_tokens, kv_width = tokens, dq
        core = 4 * tokens * n * inner
    flops = 2 * tokens * dq * inner + 2 * 2 * kv_tokens * kv_width * inner + core \
        + 2 * tokens * inner * dq
    weights = dq * inner + 2 * kv_width * inner + inner * dq + dq
    moved = tokens * dq * 2 + (kv_tokens * kv_width if s else 0) + weights
    if frames:
        moved += 2 * frames * frames * dh
    return Work(flops, moved * itemsize)


def temporal_conv(b: int, f: int, hw: int, c: int, layers: int = 4, itemsize: int = 2) -> Work:
    """One temporal convolution block: ``layers`` GroupNorm+SiLU+Conv3d
    (3, 1, 1) layers over (b, f, hw, c), plus the identity."""
    tokens = b * f * hw
    flops = layers * 2 * 3 * c * c * tokens
    moved = 2 * tokens * c + layers * (3 * c * c + 3 * c)
    return Work(flops, moved * itemsize)
