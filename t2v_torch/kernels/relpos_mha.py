"""Temporal self-attention with learned relative-position score and value
biases, in the resident layout:
``relpos_mha(q/k/v (B*T, N, H*D), k2/v2 (T, T, D), heads, frame_split=T,
scale)`` -> (B*T, N, H*D), where for every (sample, spatial token, head)

    sim = (q . k^T + q . K2[tq, tk]) * scale
    out = softmax(sim) . v + softmax(sim) . V2[tq, tk]

q/k/v arrive sample-major as the per-token projections emit them; the
frame <-> token fold never reaches device memory. On a CUDA tensor this
launches ``csrc/relpos_mha.cu`` (bf16, T up to ``MAX_T`` frames, a head dim
that is a multiple of 8 up to ``MAX_D``) under the per-shape plan of
``relpos_plan``; on a CPU tensor it runs ``relpos_mha_plain``, the
fold-and-einsum math of the JAX package's ``relpos_ref``, with the softmax
and both products in float32 and the probabilities rounded to v's dtype
before the output products.

``relpos_mha`` is differentiable. On a CUDA tensor that needs a gradient it
runs as ``RelposMHAFunction``: the forward launches the kernel, the backward
(``relpos_mha_backward``) recomputes through the fold-and-einsum math and
returns gradients for q, k, v, K2 and V2, as the JAX package's
``custom_vjp`` recomputes through ``relpos_ref``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from t2v_torch.kernels import _build

COUNTER = _build.LaunchCounter()
MAX_T = 64
MAX_D = 160
# head dims the kernel is compiled for (D is padded up to the next one)
PADDED_D = (48, 64, 80, 160)
# the card's SMs and a block's shared memory (H100 SXM)
SMS = 132
MAX_SMEM = 232448
# pairs a tile tries, largest first: one 16-row group of the token-major
# products, then fewer where the rows are wide or the pairs few
PAIR_TARGETS = (16, 8, 4, 2, 1)


def relpos_smem_bytes(tp: int, d: int, pairs: int, t: int, tables: bool, nbuf: int) -> int:
    """Shared memory of ``relpos_mha_kernel`` (``csrc/relpos_mha.cu``,
    ``relpos_smem_bytes``): a zero chunk and two mbarriers; K2 and V2 when
    staged, ``t * tp`` rows each of d or d + 8 columns (an odd count of
    16-byte chunks); ``nbuf`` tile buffers of a q, a k and a v region, each
    tp frame rows of ``pairs`` dense d-wide rows, padded to an odd count of
    16-byte chunks; two output regions of t such frame rows; and a slot a
    pair of tp rows of tp + 4 words (its f32 bias, then its bf16 P) and 4
    more."""
    table_row = 2 * (d if (d // 8) % 2 else d + 8)
    frame = 16 * ((pairs * d // 8) | 1)
    return (32 + (2 * t * tp * table_row if tables else 0) + (nbuf * 3 * tp + 2 * t) * frame
            + pairs * (tp * (tp + 4) + 4) * 4)


@dataclass(frozen=True)
class RelposPlan:
    """How ``relpos_mha_kernel`` cuts one call into tiles and blocks."""

    dp: int                # head dim rounded up to one of PADDED_D
    kt: int                # 16-frame query tiles (T <= 16 * kt)
    tokens_per_block: int  # spatial tokens of a tile
    heads_per_block: int   # heads of each token (a divisor of H)
    warps: int
    tables: bool           # K2/V2 staged in shared memory; else read from L1/L2
    buffers: int           # tile buffers: 2 loads the next tile during this one's compute
    smem_bytes: int
    tiles: int
    blocks: int            # persistent blocks, one an SM

    @property
    def pairs(self) -> int:
        return self.tokens_per_block * self.heads_per_block

    def ints(self) -> tuple[int, ...]:
        """The plan as the C entry takes it."""
        return (self.tokens_per_block, self.heads_per_block, self.warps, int(self.tables),
                self.buffers, self.blocks)


@functools.lru_cache(maxsize=None)
def relpos_plan(b: int, t: int, n: int, heads: int, d: int) -> RelposPlan:
    """Plan for ``b`` samples of ``t`` frames, ``n`` tokens and ``heads``
    heads of ``d``. A tile is a run of tokens with all their heads (or a
    group of heads, a divisor of H, when fewer pairs than heads fit):
    ``pairs`` (token, head) pairs. Up to ``SMS`` persistent blocks walk the
    tiles. The plan takes the most pairs (one 16-row group of the
    token-major products at most) that leave at least ``SMS / 2`` tiles and
    fit shared memory in one of these layouts, in order: K2/V2 staged once a
    block with two tile buffers (the next tile loads during this one's
    compute), staged with one, then the tables read from device memory
    (L1/L2) into registers as mma fragments, once per (query frame, 16-pair
    group), with two buffers or one. Tables are staged only where a block's
    share of q, k, v and out is at least their size (every block reads them
    once from L2). That order was the faster on an H100 at each of
    VideoCrafter's four levels."""
    kt = -(-t // 16)
    tp = 16 * kt
    dp = next(p for p in PADDED_D if d <= p)
    stage = 2 * t * t * d * 2 * SMS <= 4 * b * t * n * heads * d * 2
    layouts = [(tables, nbuf) for tables in ((True, False) if stage else (False,))
               for nbuf in (2, 1)]
    plans = []
    for target in PAIR_TARGETS:
        if target >= heads:
            nt, hb = min(target // heads, n), heads
        else:
            nt, hb = 1, max(x for x in range(1, target + 1) if heads % x == 0)
        tiles = b * -(-n // nt) * (heads // hb)
        for tables, nbuf in layouts:
            smem = relpos_smem_bytes(tp, d, nt * hb, t, tables, nbuf)
            if smem <= MAX_SMEM:
                plans.append(RelposPlan(dp, kt, nt, hb, 16 if dp <= 80 else 8, tables, nbuf,
                                        smem, tiles, min(tiles, SMS)))
                break
    return next((p for p in plans if 2 * p.tiles >= SMS), plans[-1])


def _relpos_math(q, k, v, k2, v2, heads: int, frame_split: int,
                 scale: float | None, mask=None) -> torch.Tensor:
    """The fold-and-einsum math of the plain version and of the recompute
    backward. ``mask`` (1 = attend, broadcast over the folded (B', T, T)
    scores) adds (1 - mask)·(-1e9) to the float32 scores."""
    bt, n, hd = q.shape
    t = frame_split
    bb = bt // t
    dh = hd // heads
    if scale is None:
        scale = dh ** -0.5
    fold = lambda z: z.reshape(bb, t, n, heads, dh).permute(0, 2, 3, 1, 4).reshape(
        bb * n * heads, t, dh).float()
    qf, kf, vf = fold(q), fold(k), fold(v)
    k2f, v2f = k2.to(q.dtype).float(), v2.to(q.dtype).float()
    sim = torch.einsum("bid,bjd->bij", qf, kf) * scale
    sim = sim + torch.einsum("btd,tsd->bts", qf, k2f) * scale
    if mask is not None:
        sim = sim + (1.0 - torch.as_tensor(mask, device=sim.device).float()) * -1e9
    attn = torch.softmax(sim, dim=-1).to(v.dtype).float()
    out = torch.einsum("bij,bjd->bid", attn, vf) + torch.einsum("bts,tsd->btd", attn, v2f)
    out = out.to(v.dtype)
    return out.reshape(bb, n, heads, t, dh).permute(0, 3, 1, 2, 4).reshape(bt, n, hd)


def relpos_mha_plain(q, k, v, k2, v2, heads: int, frame_split: int,
                     scale: float | None = None, mask=None) -> torch.Tensor:
    return _relpos_math(q, k, v, k2, v2, heads, frame_split, scale, mask)


def relpos_mha_backward(q, k, v, k2, v2, heads: int, frame_split: int, scale: float | None,
                        grad_out, needs=(True,) * 5):
    """(dq, dk, dv, dK2, dV2) by recompute through the fold-and-einsum math
    under autograd."""
    return _build.recompute_grads(
        lambda *a: _relpos_math(*a, heads, frame_split, scale), (q, k, v, k2, v2), grad_out,
        needs)


def check_args(q, k, v, k2, v2, heads: int, frame_split: int) -> None:
    """Raise ValueError on inputs the CUDA kernel does not take."""
    req = _build.require
    req(q.dim() == 3, "relpos_mha: q must be (B*T, N, H*D)")
    bt, n, hd = q.shape
    t = frame_split
    req(k.shape == q.shape and v.shape == q.shape, "relpos_mha: q, k, v shapes differ")
    req(0 < t <= MAX_T and bt % t == 0,
        f"relpos_mha: frame_split={t} must divide B*T={bt} and be at most {MAX_T}")
    req(heads > 0 and hd % heads == 0 and (hd // heads) % 8 == 0 and hd // heads <= MAX_D,
        f"relpos_mha: head dim {hd}/{heads} must be a multiple of 8 up to {MAX_D}")
    dh = hd // heads
    req(tuple(k2.shape) == (t, t, dh) and tuple(v2.shape) == (t, t, dh),
        f"relpos_mha: k2, v2 must be ({t}, {t}, {dh}), got {tuple(k2.shape)}, {tuple(v2.shape)}")
    tensors = (q, k, v, k2, v2)
    req(all(x.dtype == torch.bfloat16 for x in tensors), "relpos_mha: inputs must be bfloat16")
    req(all(x.is_contiguous() for x in tensors), "relpos_mha: inputs must be contiguous")
    req(all(x.device == q.device for x in tensors), "relpos_mha: inputs on one device")


@functools.cache
def _entry():
    """The C entry of ``csrc/relpos_mha.cu``, its argument types set once."""
    fn = _build.load("relpos_mha").t2v_relpos_mha
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _relpos_cuda(q, k, v, k2, v2, heads: int, frame_split: int, scale: float) -> torch.Tensor:
    check_args(q, k, v, k2, v2, heads, frame_split)
    bt, n, hd = q.shape
    b, d = bt // frame_split, hd // heads
    plan = relpos_plan(b, frame_split, n, heads, d)
    o = torch.empty_like(q)
    err = _entry()(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(k2), _build.ptr(v2),
                   _build.ptr(o), b, frame_split, n, heads, d, float(scale), *plan.ints(),
                   _build.stream_of(q))
    _build.check(err, "relpos_mha")
    COUNTER.hit()
    return o


class RelposMHAFunction(torch.autograd.Function):
    """``apply(q, k, v, k2, v2, heads, frame_split, scale)``: the kernel
    forward (the plain version for CPU tensors), the recompute backward."""

    @staticmethod
    def forward(ctx, q, k, v, k2, v2, heads, frame_split, scale):
        ctx.save_for_backward(q, k, v, k2, v2)
        ctx.static = (heads, frame_split, scale)
        if q.is_cuda:
            return _relpos_cuda(q, k, v, k2, v2, heads, frame_split, scale)
        return relpos_mha_plain(q, k, v, k2, v2, heads, frame_split, scale)

    @staticmethod
    def backward(ctx, grad_out):
        grads = relpos_mha_backward(*ctx.saved_tensors, *ctx.static, grad_out,
                                    ctx.needs_input_grad[:5])
        return (*grads, None, None, None)


def relpos_mha(q, k, v, k2, v2, heads: int, frame_split: int,
               scale: float | None = None) -> torch.Tensor:
    if scale is None:
        scale = (q.shape[-1] // heads) ** -0.5
    if q.is_cuda:
        if _build.needs_grad(q, k, v, k2, v2):
            return RelposMHAFunction.apply(q, k, v, k2, v2, heads, frame_split, scale)
        return _relpos_cuda(q, k, v, k2, v2, heads, frame_split, scale)
    return relpos_mha_plain(q, k, v, k2, v2, heads, frame_split, scale)
