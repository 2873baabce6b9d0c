"""The arithmetic every reference module goes through.

``Ops(fp8=False)`` is the plain float32 reference: every matrix product and
convolution in float32 with TF32 off (the caller sets the backend flags, see
``strict_fp32``). ``Ops(fp8=True)`` is the correctness control: the same
modules with every operand of a matrix product or a convolution rounded to
float8 e4m3 under a per-tensor scale (amax / 448), the step below bfloat16
that a later change could be tempted to take. Norms, softmax and the
elementwise work stay float32 in both.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, back in float32;
    a gradient passes the rounding unchanged."""
    t = t.float()
    amax = t.detach().abs().amax().clamp_min(1e-12)
    scale = amax / E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t).detach() if t.requires_grad else q


@contextlib.contextmanager
def strict_fp32():
    """TF32 off for matrix products and cuDNN convolutions while the block
    runs (a float32 product may otherwise round its inputs to 10 bits)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


class Ops:
    """Matrix products and convolutions of the reference, in float32 or,
    for the control, on float8-rounded operands (or, for a look at what
    bf16 arithmetic alone does, on bf16-rounded ones)."""

    def __init__(self, fp8: bool = False, bf16: bool = False):
        self.fp8, self.bf16 = fp8, bf16

    def _q(self, t):
        t = t.float()
        if self.bf16:
            return t.to(torch.bfloat16).float()
        return to_fp8(t) if self.fp8 else t

    def linear(self, x, w, b=None):
        y = F.linear(self._q(x), self._q(w))
        return y if b is None else y + b.float()

    def matmul(self, a, b):
        return torch.matmul(self._q(a), self._q(b))

    def conv2d(self, x, w, b=None, stride=1, padding=0):
        """x (N, H, W, C) channels-last, w (out, in, kh, kw)."""
        y = F.conv2d(self._q(x).permute(0, 3, 1, 2), self._q(w), None, stride, padding)
        y = y.permute(0, 2, 3, 1)
        return y if b is None else y + b.float()

    def conv3d(self, x, w, b=None, stride=1, padding=0):
        """x (N, T, H, W, C) channels-last, w (out, in, kt, kh, kw)."""
        y = F.conv3d(self._q(x).permute(0, 4, 1, 2, 3), self._q(w), None, stride, padding)
        y = y.permute(0, 2, 3, 4, 1)
        return y if b is None else y + b.float()

    def attention(self, q, k, v, scale: float, bias_k=None, bias_v=None,
                  max_scores: int = 1 << 28):
        """softmax(q kᵀ · scale) v over (B, N, D) x (B, S, D), in blocks of
        batch rows whose float32 scores hold at most ``max_scores``. ``bias_k``
        and ``bias_v`` (N, S, D) are relative-position terms: q·bias_k adds to
        the scores and Σ_s p·bias_v to the output."""
        out = []
        block = max(1, max_scores // (q.shape[1] * k.shape[1]))
        for i in range(0, q.shape[0], block):
            qi, ki, vi = q[i:i + block], k[i:i + block], v[i:i + block]
            s = self.matmul(qi, ki.transpose(-1, -2)) * scale
            if bias_k is not None:
                s = s + torch.einsum("bnd,nsd->bns", self._q(qi), self._q(bias_k)) * scale
            p = torch.softmax(s, dim=-1)
            o = self.matmul(p, vi)
            if bias_v is not None:
                o = o + torch.einsum("bns,nsd->bnd", self._q(p), self._q(bias_v))
            out.append(o)
        return torch.cat(out)


def group_norm(x, weight, bias, groups: int, eps: float, silu: bool = False):
    """GroupNorm of channels-last (B, ..., C): per-sample statistics over
    every middle axis and the group's channels, in float32."""
    b, c = x.shape[0], x.shape[-1]
    y = F.group_norm(x.float().reshape(b, -1, c).transpose(1, 2), groups, weight.float(),
                     bias.float(), eps).transpose(1, 2).reshape(x.shape)
    return F.silu(y) if silu else y


def layer_norm(x, weight, bias, eps: float = 1e-5):
    return F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)
