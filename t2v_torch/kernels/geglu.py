"""GEGLU combine ``geglu(proj)``: a packed ``(..., 2*inner)`` projection
``[h | gate]`` -> ``h * gelu(gate)`` of shape ``(..., inner)``, the exact
(erf) GELU, computed in float32 and rounded once to the input dtype.

On a CUDA tensor this launches ``csrc/geglu.cu`` (bf16, ``inner`` a
multiple of 8; anything else raises). On a CPU tensor it runs
``geglu_plain``. No model of the port calls it: like the JAX package,
whose ``GEGLUFeedForward`` keeps the XLA combine because the kernel
measured slower end to end on the TPU, the port's ``GEGLU`` keeps its
plain torch combine; ``chip_smoke.py`` drives this entry on the
projections a full-width ModelScope UNet call produces.

It is differentiable: on a CUDA tensor that needs a gradient it runs as
``GEGLUFunction``, whose backward is plain torch by the formula of the JAX
package's ``_geglu_bwd`` (there is no backward kernel there either).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from t2v_torch.kernels import _build

COUNTER = _build.LaunchCounter()
VEC = 8  # bf16 columns per 16-byte access of the kernel


def geglu_plain(proj: torch.Tensor) -> torch.Tensor:
    inner = proj.shape[-1] // 2
    h, gate = proj[..., :inner].float(), proj[..., inner:].float()
    return (h * F.gelu(gate)).to(proj.dtype)


def geglu_backward(proj: torch.Tensor, grad_out: torch.Tensor) -> torch.Tensor:
    """d proj of ``geglu`` for the output gradient ``grad_out``, in float32
    and rounded to proj's dtype: [dout * gelu(gate), dout * h * gelu'(gate)]
    with gelu'(g) = Phi(g) + g * phi(g)."""
    inner = proj.shape[-1] // 2
    h, g = proj[..., :inner].float(), proj[..., inner:].float()
    d = grad_out.float()
    cdf = 0.5 * (1.0 + torch.erf(g * (1.0 / math.sqrt(2.0))))
    dact = cdf + g * torch.exp(-0.5 * g * g) * (1.0 / math.sqrt(2.0 * math.pi))
    return torch.cat([d * g * cdf, d * h * dact], dim=-1).to(proj.dtype)


def check_args(proj: torch.Tensor) -> None:
    """Raise ValueError on inputs the CUDA kernel does not take."""
    req = _build.require
    req(proj.dim() >= 1 and proj.shape[-1] % 2 == 0,
        f"geglu: the last axis must hold [h | gate], got {tuple(proj.shape)}")
    inner = proj.shape[-1] // 2
    req(inner > 0 and inner % VEC == 0, f"geglu: inner={inner} must be a multiple of {VEC}")
    req(proj.dtype == torch.bfloat16, f"geglu: proj must be bfloat16, got {proj.dtype}")
    req(proj.is_contiguous(), "geglu: proj must be contiguous")
    req(proj.data_ptr() % 16 == 0, "geglu: proj must be 16-byte aligned")


def _geglu_cuda(proj: torch.Tensor) -> torch.Tensor:
    check_args(proj)
    inner = proj.shape[-1] // 2
    out = torch.empty((*proj.shape[:-1], inner), device=proj.device, dtype=proj.dtype)
    lib = _build.load("geglu")
    fn = lib.t2v_geglu
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rows = proj.numel() // proj.shape[-1]
    err = fn(_build.ptr(proj), _build.ptr(out), rows, inner, _build.stream_of(proj))
    _build.check(err, "t2v_geglu")
    COUNTER.hit()
    return out


class GEGLUFunction(torch.autograd.Function):
    """``apply(proj)``: the kernel forward (the plain version for CPU
    tensors), the plain-torch backward ``geglu_backward``."""

    @staticmethod
    def forward(ctx, proj):
        ctx.save_for_backward(proj)
        return _geglu_cuda(proj) if proj.is_cuda else geglu_plain(proj)

    @staticmethod
    def backward(ctx, grad_out):
        (proj,) = ctx.saved_tensors
        return geglu_backward(proj, grad_out)


def geglu(proj: torch.Tensor) -> torch.Tensor:
    if proj.is_cuda:
        if _build.needs_grad(proj):
            return GEGLUFunction.apply(proj)
        return _geglu_cuda(proj)
    return geglu_plain(proj)
