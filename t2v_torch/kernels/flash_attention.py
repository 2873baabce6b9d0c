"""Flash attention forward: ``flash_attention(q (B, N, D), k/v (B, S, D),
scale)`` -> (B, N, D), heads pre-folded into B.

On a CUDA tensor this launches ``csrc/flash_attention.cu`` (bf16, D of 40,
64, 80, 160 or 512); on a CPU tensor it runs ``flash_attention_plain``, dot-product
attention with an f32 softmax and the probabilities rounded to v's dtype
before the second product, as the kernel feeds them.
"""

from __future__ import annotations

import ctypes

import torch

from t2v_torch.kernels import _build

COUNTER = _build.LaunchCounter()
SUPPORTED_D = (40, 64, 80, 160, 512)


def flash_attention_plain(q, k, v, scale: float | None = None) -> torch.Tensor:
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(v.dtype)


def check_args(q, k, v) -> None:
    """Raise ValueError on inputs the CUDA kernel does not take."""
    req = _build.require
    req(q.dim() == 3 and k.dim() == 3 and v.dim() == 3, "flash_attention: q, k, v must be 3-D")
    b, n, d = q.shape
    s = k.shape[1]
    req(tuple(k.shape) == (b, s, d) and tuple(v.shape) == (b, s, d),
        f"flash_attention: k/v must be ({b}, S, {d}), got {tuple(k.shape)}, {tuple(v.shape)}")
    req(all(t.dtype == torch.bfloat16 for t in (q, k, v)),
        "flash_attention: q, k, v must be bfloat16")
    req(all(t.is_contiguous() for t in (q, k, v)), "flash_attention: q, k, v must be contiguous")
    req(k.device == q.device and v.device == q.device, "flash_attention: q, k, v on one device")
    req(d in SUPPORTED_D, f"flash_attention: head dim {d} not in {SUPPORTED_D}")


def _flash_cuda(q, k, v, scale: float) -> torch.Tensor:
    check_args(q, k, v)
    b, n, d = q.shape
    s = k.shape[1]
    lib = _build.load("flash_attention")
    fn = lib.t2v_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    o = torch.empty_like(q)
    err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
             b, n, s, d, float(scale), _build.stream_of(q))
    _build.check(err, "flash_attention")
    COUNTER.hit()
    return o


def flash_attention(q, k, v, scale: float | None = None) -> torch.Tensor:
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        return _flash_cuda(q, k, v, scale)
    return flash_attention_plain(q, k, v, scale)
