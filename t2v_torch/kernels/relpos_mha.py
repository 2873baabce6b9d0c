"""Temporal self-attention with learned relative-position score and value
biases, in the resident layout:
``relpos_mha(q/k/v (B*T, N, H*D), k2/v2 (T, T, D), heads, frame_split=T,
scale)`` -> (B*T, N, H*D), where for every (sample, spatial token, head)

    sim = (q . k^T + q . K2[tq, tk]) * scale
    out = softmax(sim) . v + softmax(sim) . V2[tq, tk]

q/k/v arrive sample-major as the per-token projections emit them; the
frame <-> token fold never reaches device memory. On a CUDA tensor this
launches ``csrc/relpos_mha.cu`` (bf16); on a CPU tensor it runs
``relpos_mha_plain``, the fold-and-einsum math of the JAX package's
``relpos_ref``, with the softmax and both products in float32 and the
probabilities rounded to v's dtype before the output products.
"""

from __future__ import annotations

import ctypes

import torch

from t2v_torch.kernels import _build

COUNTER = _build.LaunchCounter()
MAX_T = 64


def relpos_mha_plain(q, k, v, k2, v2, heads: int, frame_split: int,
                     scale: float | None = None) -> torch.Tensor:
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
    attn = torch.softmax(sim, dim=-1).to(v.dtype).float()
    out = torch.einsum("bij,bjd->bid", attn, vf) + torch.einsum("bts,tsd->btd", attn, v2f)
    out = out.to(v.dtype)
    return out.reshape(bb, n, heads, t, dh).permute(0, 3, 1, 2, 4).reshape(bt, n, hd)


def check_args(q, k, v, k2, v2, heads: int, frame_split: int) -> None:
    """Raise ValueError on inputs the CUDA kernel does not take."""
    req = _build.require
    req(q.dim() == 3, "relpos_mha: q must be (B*T, N, H*D)")
    bt, n, hd = q.shape
    t = frame_split
    req(k.shape == q.shape and v.shape == q.shape, "relpos_mha: q, k, v shapes differ")
    req(0 < t <= MAX_T and bt % t == 0,
        f"relpos_mha: frame_split={t} must divide B*T={bt} and be at most {MAX_T}")
    req(heads > 0 and hd % heads == 0 and (hd // heads) % 8 == 0,
        f"relpos_mha: head dim {hd}/{heads} must be a multiple of 8")
    dh = hd // heads
    req(tuple(k2.shape) == (t, t, dh) and tuple(v2.shape) == (t, t, dh),
        f"relpos_mha: k2, v2 must be ({t}, {t}, {dh}), got {tuple(k2.shape)}, {tuple(v2.shape)}")
    tensors = (q, k, v, k2, v2)
    req(all(x.dtype == torch.bfloat16 for x in tensors), "relpos_mha: inputs must be bfloat16")
    req(all(x.is_contiguous() for x in tensors), "relpos_mha: inputs must be contiguous")
    req(all(x.device == q.device for x in tensors), "relpos_mha: inputs on one device")


def _relpos_cuda(q, k, v, k2, v2, heads: int, frame_split: int, scale: float) -> torch.Tensor:
    check_args(q, k, v, k2, v2, heads, frame_split)
    bt, n, hd = q.shape
    lib = _build.load("relpos_mha")
    fn = lib.t2v_relpos_mha
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    o = torch.empty_like(q)
    err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(k2), _build.ptr(v2),
             _build.ptr(o), bt // frame_split, frame_split, n, heads, hd // heads, float(scale),
             _build.stream_of(q))
    _build.check(err, "relpos_mha")
    COUNTER.hit()
    return o


def relpos_mha(q, k, v, k2, v2, heads: int, frame_split: int,
               scale: float | None = None) -> torch.Tensor:
    if scale is None:
        scale = (q.shape[-1] // heads) ** -0.5
    if q.is_cuda:
        return _relpos_cuda(q, k, v, k2, v2, heads, frame_split, scale)
    return relpos_mha_plain(q, k, v, k2, v2, heads, frame_split, scale)
