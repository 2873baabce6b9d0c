#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``t2v_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. build every CUDA kernel from ``t2v_torch/csrc`` (one ``nvcc`` per
   source, all started together) and print the build time;
2. check that each wrapper refuses malformed CUDA tensors, then hold each
   kernel against its plain PyTorch version on the card, in bf16, at every
   shape the driven paths give it (24-, 125- and 250-frame ModelScope,
   16-frame VideoCrafter) plus ragged ones; print the max error against the
   stated tolerance and the kernel's, the plain version's and, where one
   PyTorch call computes the same function, that library call's time (timed
   here as a yardstick only: the port never calls it);
3. answer one request with a small ModelScope pipeline and one with a small
   VideoCrafter pipeline whose widths every kernel takes, in bf16 on the
   card, and hold their latents and frames against the same weights in
   float32 on the CPU (``check_small_pipeline``, ``check_small_vc_pipeline``);
4. build ``ModelScopePipeline.random_init`` at the full configs (1.41B-
   parameter UNet, ViT-H text tower, SD VAE) in bf16 on the card, perturb
   the zero-initialised leaves, and answer two txt2vid requests (24 frames
   at 256x256, 20 DDIM_Gaussian steps, CFG 9) and one 125-frame request
   (256x256, 4 steps, CFG 9). For each, print the seconds per phase, the
   peak memory, the frames' shape, dtype and finiteness, and each kernel's
   launch count, which must equal the count the UNet topology predicts;
   time one 24-frame UNet call and break its device time down by kernel
   category with torch.profiler;
5. the same with ``VideoCrafterPipeline.random_init`` at full width (CLIP-L
   tower, 8-head UNet with relative-position temporal attention, SD VAE):
   two requests (16 frames at 256x256, 20 DDIM steps, CFG 9), counted
   launches, and the breakdown of one UNet call. No plain version of a
   kernel may run on a CUDA tensor in phases 4 and 5;
6. print the card's name and power limit, one ``{"kernels": [...]}`` line,
   and as the last line ``{"ok": true, "device": {...}}``.

It exits non-zero without a GPU, and in a directory without the port.
``--only kernels|small|modelscope|videocrafter`` runs the build and one
group of phases (for work on one of them; it prints no result line).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# a kernel agrees with its plain version when its max abs error is within
# this share of the largest |output|: about 2.5 bf16 ulps there. Both round
# at the same points; they differ in f32 summation order, which can flip
# one bf16 rounding, and such flips carry through the chain's four layers
TOL_SHARE = 0.02

T = 24            # frames of the ModelScope request
T_LONG = 125      # frames of the long ModelScope request
LAT = 32          # 256 px / 8
STEPS = 20
STEPS_LONG = 4
CFG = 9.0
VC_T = 16         # frames of the VideoCrafter request
VC_STEPS = 20


def _fail(msg: str) -> None:
    raise RuntimeError(msg)


def _time_ms(fn, iters: int) -> float:
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _release() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()


class KernelRecord:
    def __init__(self, name, source, replaces, path, counter=None):
        self.name, self.source, self.replaces = name, source, replaces
        self.path = path  # the driven path whose launches the JSON line reports
        self.counter = counter or name  # the wrapper's launch count it reads
        self.max_abs_err = 0.0
        self.main = None  # timings at that path's dominant shape

    def timed(self, shape, ms, plain_ms, library_ms, flops, nbytes, main=False) -> None:
        """Print one launch's time at ``shape`` beside its bound, the plain
        version's and the library call's (None: no PyTorch call computes the
        function); keep it for the JSON line when it is the dominant shape."""
        bound, by = _bound_ms(flops, nbytes)
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"  time {self.name:18s} {str(tuple(shape)):26s} kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {lib}, bound {bound:.4f} ms ({by})", flush=True)
        if main:
            self.main = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                         "library_ms": library_ms, "shape": list(shape)}

    def as_json(self, launches: dict) -> dict:
        return {"name": self.name, "route": "cuda", "source": self.source,
                "replaces": self.replaces, "launches": launches[self.path][self.counter],
                "max_abs_err": self.max_abs_err, **self.main, "path": self.path,
                "launches_by_path": {p: c[self.counter] for p, c in launches.items()}}


def _compare(rec: KernelRecord, label: str, got, want) -> None:
    import torch

    if not torch.isfinite(got).all():
        _fail(f"{rec.name} {label}: kernel output is not finite")
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    rel = err / scale
    ok = err <= TOL_SHARE * scale
    print(f"  {rec.name:18s} {label:38s} max_abs_err={err:.3e} rel={rel:.3e} "
          f"tol={TOL_SHARE * scale:.3e} {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        _fail(f"{rec.name} {label}: max abs error {err} above {TOL_SHARE * scale}")
    rec.max_abs_err = max(rec.max_abs_err, err)


def _chain_layers(g, c, n=4):
    import torch

    dev = "cuda"
    return [(
        1.0 + 0.1 * torch.randn((c,), generator=g, device=dev),
        0.1 * torch.randn((c,), generator=g, device=dev),
        (torch.randn((3, c, c), generator=g, device=dev) / math.sqrt(3 * c)).to(torch.bfloat16),
        (0.1 * torch.randn((c,), generator=g, device=dev)).to(torch.bfloat16),
    ) for _ in range(n)]


def _time_temporal_layer(rec, tc, x, layer, main) -> None:
    """One stats-emitting layer (three of every four launches) beside its
    plain version; the library yardstick is one matmul of the pre-activated,
    frame-shifted input (B*F*HW, 3C) by the stacked taps (3C, C)."""
    import torch

    b, f, hw, c = x.shape
    fin = tc.finalize_stats(tc.input_stats(x), f * hw, 1e-5)
    s, bias, w, cb = layer
    ms = _time_ms(lambda: tc.temporal_conv_layer(x, fin, s, bias, w, cb), 10)
    plain_ms = _time_ms(lambda: tc.layer_plain(x, fin, s, bias, w, cb), 3)
    a = torch.cat([
        torch.nn.functional.silu(
            (x[:, f0:f0 + 25].float() - fin[:, 0, None, None]) * fin[:, 1, None, None]
        ).to(torch.bfloat16) for f0 in range(0, f, 25)], dim=1)
    a = torch.nn.functional.pad(a, (0, 0, 0, 0, 1, 1))
    a_cat = torch.cat([a[:, k:k + f] for k in range(3)], dim=-1).reshape(-1, 3 * c)
    del a
    w_cat = w.reshape(3 * c, c)
    lib_ms = _time_ms(lambda: torch.matmul(a_cat, w_cat), 10)
    m = b * f * hw
    rec.timed((b, f, hw, c), ms, plain_ms, lib_ms, 2.0 * m * 3 * c * c,
              2 * m * c * 2 + 3 * c * c * 2, main=main)


def check_temporal_conv(g) -> list[KernelRecord]:
    import torch

    from t2v_torch.kernels import temporal_conv as tc

    rec = KernelRecord("temporal_conv", "t2v_torch/csrc/temporal_conv.cu",
                       "t2v/kernels/temporal_conv.py:197", "modelscope_24f")
    dev = "cuda"
    # (B, F, HW, C): the four UNet levels at 24 frames with CFG, a ragged one
    ragged = (1, 5, 37, 128)
    shapes = [(2, T, 1024, 320), (2, T, 256, 640), (2, T, 64, 1280), (2, T, 16, 1280), ragged]
    for b, f, hw, c in shapes:
        x = torch.randn((b, f, hw, c), generator=g, device=dev).to(torch.bfloat16)
        layers = _chain_layers(g, c)
        got = tc.temporal_conv_chain(x, layers)
        want = tc.chain_plain(x, layers)
        torch.cuda.synchronize()
        _compare(rec, f"chain x{tuple(x.shape)}", got, want)
        if (b, f, hw, c) != ragged:  # the ragged one is checked, not timed
            _time_temporal_layer(rec, tc, x, layers[0], main=(hw, c) == (1024, 320))

    # the long videos, for which the TPU package has a second, frame-chunked
    # kernel: the 125-frame request's levels and every 250-frame level, on a
    # stats-emitting layer (output and emitted statistics) and on the
    # residual layer, each against layer_plain on the same inputs
    long = KernelRecord("temporal_conv_long", "t2v_torch/csrc/temporal_conv.cu",
                        "t2v/kernels/temporal_conv.py:254", "modelscope_125f",
                        counter="temporal_conv")
    long_shapes = [(2, T_LONG, 1024, 320), (2, T_LONG, 256, 640), (2, T_LONG, 64, 1280),
                   (2, T_LONG, 16, 1280), (2, 250, 1024, 320), (2, 250, 256, 640),
                   (2, 250, 64, 1280), (2, 250, 16, 1280), (1, 131, 9, 64)]
    for b, f, hw, c in long_shapes:
        x = torch.randn((b, f, hw, c), generator=g, device=dev).to(torch.bfloat16)
        layer = _chain_layers(g, c, 1)[0]
        fin = tc.finalize_stats(tc.input_stats(x), f * hw, 1e-5)
        got, raw = tc.temporal_conv_layer(x, fin, *layer)
        want, raw_want = tc.layer_plain(x, fin, *layer)
        _compare(long, f"stats layer x{tuple(x.shape)}", got, want)
        # the per-channel sums of F*HW bf16 values: compared in units of the
        # count, which keeps one flipped rounding per value inside TOL_SHARE
        _compare(long, f"emitted stats x{tuple(x.shape)}", raw / (f * hw), raw_want / (f * hw))
        del want, raw_want
        res = torch.randn((b, f, hw, c), generator=g, device=dev).to(torch.bfloat16)
        got, _ = tc.temporal_conv_layer(x, fin, *layer, residual=res, emit_stats=False)
        want, _ = tc.layer_plain(x, fin, *layer, residual=res, emit_stats=False)
        torch.cuda.synchronize()
        _compare(long, f"residual layer x{tuple(x.shape)}", got, want)
        del got, want, res
        if c >= 320:  # the ragged one is checked, not timed
            _time_temporal_layer(long, tc, x, layer, main=(f, hw) == (T_LONG, 1024))
        del x
        _release()
    return [rec, long]


def _attn_flops_bytes(b, n, s, d, heads=1):
    return 4.0 * b * heads * n * s * d, 2.0 * b * heads * d * (2 * n + 2 * s)


def check_flash(g) -> list[KernelRecord]:
    import torch
    import torch.nn.functional as F

    from t2v_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    rec = KernelRecord("flash_attention", "t2v_torch/csrc/flash_attention.cu",
                       "t2v/kernels/flash_attention.py:33", "modelscope_24f")
    # (B, N, S, D, scale): ModelScope 32x32 spatial self-attention at 24 frames
    # (2 x 24 x 5 heads) and at 125 frames, VideoCrafter's at 40-wide heads
    # (2 x 16 x 8), the VAE mid-block attention, and ragged ones
    ragged = [(3, 333, 777, 64, 0.125), (3, 333, 777, 40, 40 ** -0.5), (2, 70, 600, 160, 0.1)]
    cases = [(240, 1024, 1024, 64, 0.125), (1250, 1024, 1024, 64, 0.125),
             (256, 1024, 1024, 40, 40 ** -0.5), (24, 1024, 1024, 512, 512 ** -0.5), *ragged]
    for b, n, s, d, scale in cases:
        q = torch.randn((b, n, d), generator=g, device="cuda").to(torch.bfloat16)
        k = torch.randn((b, s, d), generator=g, device="cuda").to(torch.bfloat16)
        v = torch.randn((b, s, d), generator=g, device="cuda").to(torch.bfloat16)
        got = flash_attention(q, k, v, scale)
        want = flash_attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        _compare(rec, f"q{(b, n, d)} kv{(b, s, d)}", got, want)
        del got, want
        if (b, n, s, d, scale) in ragged:  # checked, not timed
            continue
        ms = _time_ms(lambda: flash_attention(q, k, v, scale), 10)
        plain_ms = _time_ms(lambda: flash_attention_plain(q, k, v, scale), 3)
        # SDPA takes its fused paths on 4-D (batch, heads, seq, dim) input
        q4, k4, v4 = q[:, None], k[:, None], v[:, None]
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale), 10)
        rec.timed((b, n, s, d), ms, plain_ms, lib_ms, *_attn_flops_bytes(b, n, s, d),
                  main=(b, d) == (240, 64))
        _release()
    return [rec]


def check_fused_mha(g) -> list[KernelRecord]:
    import torch
    import torch.nn.functional as F

    from t2v_torch.kernels.fused_mha import (
        fused_cross_mha,
        fused_cross_mha_plain,
        fused_self_mha,
        fused_self_mha_plain,
    )

    rec = KernelRecord("fused_self_mha", "t2v_torch/csrc/fused_mha.cu",
                       "t2v/kernels/fused_mha.py:52", "modelscope_24f")
    # (B, N, heads, D). ModelScope (D = 64): spatial self-attention at 16x16,
    # 8x8 and 4x4 (2 x 24 and 2 x 125 frames), temporal self-attention over
    # 24 and 125 frames at every level and over 250 at the 32x32 and 8x8 ones;
    # VideoCrafter (8 heads, D = 80 and 160): spatial self-attention at 16x16,
    # 8x8 and 4x4; ragged ones at every head dim
    ragged = [(7, 13, 3, 64), (3, 50, 2, 40), (7, 13, 3, 80), (5, 29, 2, 160)]
    cases = [(48, 256, 10, 64), (48, 64, 20, 64), (48, 16, 20, 64), (2048, 24, 5, 64),
             (2048, 24, 8, 64), (512, 24, 10, 64), (128, 24, 20, 64), (32, 24, 20, 64),
             (250, 256, 10, 64), (250, 64, 20, 64), (250, 16, 20, 64),
             (2048, 125, 5, 64), (2048, 125, 8, 64), (512, 125, 10, 64), (128, 125, 20, 64),
             (32, 125, 20, 64), (2048, 250, 5, 64), (128, 250, 20, 64),
             (32, 256, 8, 80), (32, 64, 8, 160), (32, 16, 8, 160), *ragged]
    for b, n, h, d in cases:
        hd = h * d
        q, k, v = (torch.randn((b, n, hd), generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        got = fused_self_mha(q, k, v, h)
        want = fused_self_mha_plain(q, k, v, h)
        torch.cuda.synchronize()
        _compare(rec, f"x{(b, n, hd)} heads={h}", got, want)
        del got, want
        if (b, n, h, d) in ragged:  # checked, not timed
            continue
        fold = lambda t: t.view(b, n, h, d).transpose(1, 2)
        ms = _time_ms(lambda: fused_self_mha(q, k, v, h), 20)
        plain_ms = _time_ms(lambda: fused_self_mha_plain(q, k, v, h), 3)
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(fold(q), fold(k), fold(v)), 20)
        rec.timed((b, n, hd, h), ms, plain_ms, lib_ms, *_attn_flops_bytes(b, n, n, d, h),
                  main=(b, n, h) == (48, 256, 10))
        _release()

    cross = KernelRecord("fused_cross_mha", "t2v_torch/csrc/fused_mha.cu",
                         "t2v/kernels/fused_mha.py:225", "videocrafter_16f")
    # (B, N, S, heads, D): VideoCrafter's spatial cross-attention, 16 frames
    # of tokens merged into the query rows over the 77-token context, at its
    # four levels; a ragged one; and one context too long for shared memory,
    # which takes the streaming kernel
    ragged = [(3, 1000, 50, 5, 40), (2, 300, 200, 2, 64)]
    cases = [(2, 16384, 77, 8, 40), (2, 4096, 77, 8, 80), (2, 1024, 77, 8, 160),
             (2, 256, 77, 8, 160), *ragged]
    for b, n, s, h, d in cases:
        hd = h * d
        q = torch.randn((b, n, hd), generator=g, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((b, s, hd), generator=g, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        got = fused_cross_mha(q, k, v, h)
        want = fused_cross_mha_plain(q, k, v, h)
        torch.cuda.synchronize()
        _compare(cross, f"q{(b, n, hd)} kv{(b, s, hd)} heads={h}", got, want)
        del got, want
        if (b, n, s, h, d) in ragged:  # checked, not timed
            continue
        fold = lambda t: t.view(b, t.shape[1], h, d).transpose(1, 2)
        ms = _time_ms(lambda: fused_cross_mha(q, k, v, h), 20)
        plain_ms = _time_ms(lambda: fused_cross_mha_plain(q, k, v, h), 3)
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(fold(q), fold(k), fold(v)), 20)
        cross.timed((b, n, s, hd, h), ms, plain_ms, lib_ms, *_attn_flops_bytes(b, n, s, d, h),
                    main=n == 16384)
    return [rec, cross]


def check_relpos(g) -> list[KernelRecord]:
    import torch

    from t2v_torch.kernels.relpos_mha import relpos_mha, relpos_mha_plain

    rec = KernelRecord("relpos_mha", "t2v_torch/csrc/relpos_mha.cu",
                       "t2v/kernels/relpos_mha.py:80", "videocrafter_16f")
    # (B, T, N, heads, D): VideoCrafter's temporal attention over 16 frames at
    # its four levels (CFG batch 2); a ragged one; one above 16 frames; one
    # whose bias tables do not fit shared memory and are read through L2.
    # No library call computes this function: scaled_dot_product_attention
    # takes an additive score bias but has no term for softmax(sim) . V2.
    ragged = [(2, 5, 37, 3, 24), (2, 24, 8, 2, 40), (1, 40, 6, 2, 160)]
    cases = [(2, 16, 1024, 8, 40), (2, 16, 256, 8, 80), (2, 16, 64, 8, 160),
             (2, 16, 16, 8, 160), *ragged]
    for b, t, n, h, d in cases:
        hd = h * d
        q, k, v = (torch.randn((b * t, n, hd), generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        k2, v2 = (torch.randn((t, t, d), generator=g, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        got = relpos_mha(q, k, v, k2, v2, h, t)
        want = relpos_mha_plain(q, k, v, k2, v2, h, t)
        torch.cuda.synchronize()
        _compare(rec, f"x{(b * t, n, hd)} heads={h} T={t}", got, want)
        del got, want
        if (b, t, n, h, d) in ragged:  # checked, not timed
            continue
        ms = _time_ms(lambda: relpos_mha(q, k, v, k2, v2, h, t), 20)
        plain_ms = _time_ms(lambda: relpos_mha_plain(q, k, v, k2, v2, h, t), 3)
        items = b * n * h
        rec.timed((b * t, n, hd, h), ms, plain_ms, None, 8.0 * items * t * t * d,
                  2.0 * (4 * b * t * n * hd + 2 * t * t * d), main=n == 1024)
    return [rec]


def build_kernels() -> float:
    from t2v_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build(list(_build.KERNELS))
    secs = time.perf_counter() - t0
    for name, log in logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        spills = [ln for ln in regs if "spill" in ln and "0 bytes spill stores, 0 bytes spill" not in ln]
        print(f"  {name}: {len(regs) // 2} kernels, "
              + (" | ".join(regs[:2]) if regs else "(built before)")
              + (f" | SPILLS: {' | '.join(spills[:3])}" if spills else ""), flush=True)
    print(f"build: {secs:.1f} s for {len(logs)} sources", flush=True)
    return secs


def check_refusals() -> None:
    """Each wrapper raises ValueError on a CUDA tensor its kernel does not
    take (wrong dtype, shape or contiguity), and launches nothing."""
    import torch

    from t2v_torch.kernels import flash_attention, fused_mha, relpos_mha, temporal_conv

    def bf16(*shape):
        return torch.zeros(shape, device="cuda", dtype=torch.bfloat16)

    c = 64
    vec = torch.zeros(c, device="cuda")
    fin = torch.zeros(2, 2, c, device="cuda")
    w = bf16(3, c, c)
    q = bf16(2, 24, 2 * 64)
    rq = bf16(8, 6, 80)  # rel-pos: 2 samples x 4 frames, 6 tokens, 2 heads of 40
    r2 = bf16(4, 4, 40)
    bad_calls = {
        "temporal_conv float32 x": lambda: temporal_conv.temporal_conv_layer(
            bf16(2, 3, 8, c).float(), fin, vec, vec, w, vec),
        "temporal_conv strided x": lambda: temporal_conv.temporal_conv_layer(
            bf16(2, 8, 3, c).transpose(1, 2), fin, vec, vec, w, vec),
        "temporal_conv weight shape": lambda: temporal_conv.temporal_conv_layer(
            bf16(2, 3, 8, c), fin, vec, vec, bf16(3, c, 32), vec),
        "flash float32": lambda: flash_attention.flash_attention(
            *(bf16(2, 8, 64).float() for _ in range(3))),
        "flash head dim 48": lambda: flash_attention.flash_attention(
            *(bf16(2, 8, 48) for _ in range(3))),
        "flash strided q": lambda: flash_attention.flash_attention(
            bf16(2, 64, 8).transpose(1, 2), bf16(2, 8, 64), bf16(2, 8, 64)),
        "fused_self_mha float32": lambda: fused_mha.fused_self_mha(q.float(), q.float(), q.float(), 2),
        "fused_self_mha N 512": lambda: fused_mha.fused_self_mha(*(bf16(2, 512, 128),) * 3, 2),
        "fused_self_mha head dim 32": lambda: fused_mha.fused_self_mha(*(bf16(2, 24, 64),) * 3, 2),
        "fused_self_mha strided": lambda: fused_mha.fused_self_mha(
            *(bf16(2, 128, 24).transpose(1, 2),) * 3, 2),
        "fused_cross_mha float32 q": lambda: fused_mha.fused_cross_mha(
            q.float(), bf16(2, 77, 128), bf16(2, 77, 128), 2),
        "fused_cross_mha context batch": lambda: fused_mha.fused_cross_mha(
            q, bf16(3, 77, 128), bf16(3, 77, 128), 2),
        "fused_cross_mha S 512": lambda: fused_mha.fused_cross_mha(
            q, bf16(2, 512, 128), bf16(2, 512, 128), 2),
        "fused_cross_mha k/v widths": lambda: fused_mha.fused_cross_mha(
            q, bf16(2, 77, 64), bf16(2, 77, 64), 2),
        "relpos_mha float32": lambda: relpos_mha.relpos_mha(
            rq.float(), rq.float(), rq.float(), r2.float(), r2.float(), 2, 4),
        "relpos_mha frame_split": lambda: relpos_mha.relpos_mha(rq, rq, rq, r2, r2, 2, 3),
        "relpos_mha table shape": lambda: relpos_mha.relpos_mha(
            rq, rq, rq, bf16(4, 4, 80), bf16(4, 4, 80), 2, 4),
        "relpos_mha head dim 20": lambda: relpos_mha.relpos_mha(
            rq, rq, rq, bf16(4, 4, 20), bf16(4, 4, 20), 4, 4),
        "relpos_mha strided": lambda: relpos_mha.relpos_mha(
            *(bf16(8, 80, 6).transpose(1, 2),) * 3, r2, r2, 2, 4),
    }
    counters = _counters().values()
    before = [k.count for k in counters]
    for label, call in bad_calls.items():
        try:
            call()
        except ValueError:
            continue
        _fail(f"{label}: the wrapper accepted a CUDA tensor its kernel does not take")
    if [k.count for k in counters] != before:
        _fail("a refused call counted a launch")
    print(f"refusals: {len(bad_calls)} malformed CUDA inputs raised ValueError", flush=True)


def check_kernels() -> list[KernelRecord]:
    import torch

    check_refusals()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    with torch.no_grad():
        return [*check_temporal_conv(g), *check_flash(g), *check_fused_mha(g),
                *check_relpos(g)]


def _models(pipe):
    text = pipe.text_encoder.model if hasattr(pipe, "text_encoder") else pipe.clip
    return pipe.unet, pipe.vae, text


def _perturb_zero_leaves(pipe) -> None:
    """Add 0.01 to every all-zero parameter: the zero-initialised gates of a
    random-weight pipeline would make every UNet output 0, and VideoCrafter's
    zero temporal q/k/v/out would leave its rel-pos kernel without signal."""
    import torch

    with torch.no_grad():
        for mod in _models(pipe):
            for p in mod.parameters():
                if not p.any():
                    p.add_(0.01)


def _counters():
    from t2v_torch.kernels import flash_attention, fused_mha, relpos_mha, temporal_conv

    return {"temporal_conv": temporal_conv.COUNTER, "flash_attention": flash_attention.COUNTER,
            "fused_self_mha": fused_mha.COUNTER, "fused_cross_mha": fused_mha.CROSS_COUNTER,
            "relpos_mha": relpos_mha.COUNTER}


def _reset_counters() -> None:
    for c in _counters().values():
        c.reset()


def _read_counters() -> dict:
    return {k: c.count for k, c in _counters().items()}


@contextlib.contextmanager
def _no_plain_on_cuda():
    """While active, a kernel wrapper's plain version raises when it is
    handed a CUDA tensor: the driven paths must go through the kernels.
    (The dispatch's own short-context attention, ``attention.attention_plain``,
    is not a wrapper's fallback and is left alone.)"""
    from t2v_torch.kernels import flash_attention, fused_mha, relpos_mha, temporal_conv

    targets = [(flash_attention, "flash_attention_plain"), (fused_mha, "fused_self_mha_plain"),
               (fused_mha, "fused_cross_mha_plain"), (relpos_mha, "relpos_mha_plain"),
               (temporal_conv, "layer_plain")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def guard(name, fn):
        def guarded(x, *args, **kwargs):
            if x.is_cuda:
                _fail(f"{name} ran on a CUDA tensor: a wrapper fell back to its plain version")
            return fn(x, *args, **kwargs)
        return guarded

    for mod, name, fn in saved:
        setattr(mod, name, guard(name, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# small pipelines whose widths every kernel takes. ModelScope: channels a
# multiple of 64, 64-wide heads; VideoCrafter: 160 and 320 channels over 4
# heads, i.e. the 40- and 80-wide heads of the full model's upper levels.
# At 64x64 px (a 32x32 latent under the two-level VAE) the 1,024-token
# attention goes to flash and the rest to the packed kernels
SMALL_UNET = dict(dim=64, context_dim=64, dim_mult=(1, 2), num_res_blocks=1, num_heads=1,
                  head_dim=64, attn_scales=(1.0, 0.5))
SMALL_VC_UNET = dict(model_channels=160, context_dim=64, channel_mult=(1, 2), num_res_blocks=1,
                     num_heads=4, attention_resolutions=(1, 2), temporal_length=8)
# the card's bf16 run may be at most this many times as far from the float32
# reference as the plain bf16 run on the CPU: both round at the same points
# and differ in summation order, so their distances are of one size
SMALL_RATIO = 2.0


def _small_pipeline_check(label, build, args, noise, device) -> dict:
    """One seeded small pipeline answers one request from the same starting
    noise three times: float32 on the CPU (the reference), bf16 on the CPU
    (the plain versions: the distance bf16 alone makes), and bf16 on
    ``device`` (the kernels). Fails when the last is more than SMALL_RATIO
    times as far from the reference as the second, in relative RMS of the
    final latents and of the uint8 frames. ``build(policy, device)`` makes
    the pipeline. Returns the kernels' launches in the ``device`` run."""
    import torch

    from t2v_torch.core.dtypes import Policy

    ref = build(Policy.fp32(), "cpu")
    _perturb_zero_leaves(ref)

    def copy(policy, dev):
        pipe = build(policy, dev)
        for dst, src in zip(_models(pipe), _models(ref)):
            dst.load_state_dict(src.state_dict())
        return pipe

    want = ref.infer(args, noise=noise)
    cpu16 = copy(Policy.bf16(), "cpu").infer(args, noise=noise)
    pipe = copy(Policy.bf16(), device)
    _reset_counters()
    got = pipe.infer(args, noise=noise)
    launches = _read_counters()

    def rel(a, b) -> float:
        a, b = torch.as_tensor(a).double().cpu(), torch.as_tensor(b).double().cpu()
        return ((a - b).norm() / b.norm()).item()

    for what, pick in (("latents", lambda r: r.latents), ("frames", lambda r: r.frames)):
        err, floor = rel(pick(got), pick(want)), rel(pick(cpu16), pick(want))
        ok = err <= SMALL_RATIO * floor
        print(f"{label} {what}: bf16 on {device} {err:.3e} from the float32 reference, "
              f"bf16 on cpu {floor:.3e}, limit {SMALL_RATIO * floor:.3e} "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            _fail(f"{label} {what}: {err} from the reference, above {SMALL_RATIO} x {floor}")
    print(f"{label} launches on {device}: {launches}", flush=True)
    return launches


def check_small_pipeline(device: str = "cuda") -> dict:
    """The ModelScope path on a small input against a float32 reference:
    8 frames at 64x64, 4 DDIM_Gaussian steps, CFG 9."""
    import torch

    from t2v_torch.core.config import ModelScopeUNetConfig, T2VArgs
    from t2v_torch.pipeline.pipeline import ModelScopePipeline

    cfg = ModelScopeUNetConfig(**SMALL_UNET)
    args = T2VArgs(prompt="a (red:1.2) fox running in the snow", seed=3, steps=4, frames=8,
                   width=64, height=64, cfg_scale=CFG)
    noise = torch.randn((1, 8, 32, 32, 4), generator=torch.Generator().manual_seed(3))
    return _small_pipeline_check(
        "small pipeline",
        lambda policy, dev: ModelScopePipeline.random_init(cfg, policy, seed=0, device=dev),
        args, noise, device)


def check_small_vc_pipeline(device: str = "cuda") -> dict:
    """The VideoCrafter path on a small input against a float32 reference:
    8 frames at 64x64, 4 DDIM steps, CFG 9; the zero-initialised temporal
    q/k/v/out are perturbed with the other zero leaves, so the rel-pos
    kernel carries signal."""
    import torch

    from t2v_torch.core.config import T2VArgs, VideoCrafterUNetConfig
    from t2v_torch.pipeline.videocrafter import VideoCrafterPipeline

    cfg = VideoCrafterUNetConfig(**SMALL_VC_UNET)
    args = T2VArgs(prompt="a red fox running in the snow", n_prompt="blurry", seed=3, steps=4,
                   frames=8, width=64, height=64, cfg_scale=CFG)
    noise = torch.randn((1, 8, 32, 32, 4), generator=torch.Generator().manual_seed(4))
    return _small_pipeline_check(
        "small VideoCrafter pipeline",
        lambda policy, dev: VideoCrafterPipeline.random_init(cfg, policy, seed=0, device=dev,
                                                             small_aux=True),
        args, noise, device)


def _run_request(label, pipe, args, frames, expected) -> dict:
    """One full-width request: seconds per phase, peak memory, the frames'
    shape and finiteness, and the launch counts against ``expected``."""
    import numpy as np
    import torch

    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.perf_counter()
    with _no_plain_on_cuda():
        res = pipe.infer(args)
    total = time.perf_counter() - t0
    counts = _read_counters()
    peak = torch.cuda.max_memory_allocated() / 2**30
    fr = res.frames
    finite = bool(np.isfinite(res.latents.cpu().numpy()).all())
    tm = res.timings
    print(f"{label}: {total:.3f} s/video (text {tm['text']:.3f}, sample "
          f"{tm['sample']:.3f}, decode {tm['decode']:.3f}; {1e3 * tm['sample'] / args.steps:.2f} "
          f"ms per step over {args.steps} steps), peak {peak:.2f} GiB, frames "
          f"{fr.shape} {fr.dtype}, latents finite={finite}, frame mean {fr.mean():.2f} "
          f"std {fr.std():.2f}, launches {counts}", flush=True)
    if fr.shape != (frames, 256, 256, 3) or fr.dtype != np.uint8:
        _fail(f"{label}: frames {fr.shape} {fr.dtype}, expected ({frames}, 256, 256, 3) uint8")
    if not finite:
        _fail(f"{label}: latents are not finite")
    if fr.std() == 0:
        _fail(f"{label}: every pixel is the same")
    if counts != expected:
        _fail(f"{label}: launch counts {counts} differ from the topology's {expected}")
    return counts


def _expected(per_call: dict, steps: int, decodes: int) -> dict:
    out = {k: 0 for k in _counters()}
    out.update({k: steps * v for k, v in per_call.items()})
    out["flash_attention"] += decodes  # the VAE's mid-block attention, once per decode call
    return out


def drive_modelscope() -> dict:
    """Two full-width 24-frame requests, one UNet-call profile, one
    125-frame request; returns the kernels' launches per path."""
    import torch

    from t2v_torch.core.config import ModelScopeUNetConfig, T2VArgs
    from t2v_torch.core.dtypes import Policy
    from t2v_torch.models.modelscope_unet import count_kernel_sites
    from t2v_torch.pipeline.pipeline import ModelScopePipeline, decode_chunk_frames

    t0 = time.perf_counter()
    pipe = ModelScopePipeline.random_init(ModelScopeUNetConfig(), Policy.bf16(), seed=0,
                                          device="cuda")
    _perturb_zero_leaves(pipe)
    n_unet = sum(p.numel() for p in pipe.unet.parameters())
    torch.cuda.synchronize()
    print(f"ModelScope pipeline: random_init {time.perf_counter() - t0:.1f} s, UNet "
          f"{n_unet / 1e9:.3f}B params, bf16 on {torch.cuda.get_device_name(0)}", flush=True)

    launches = {}
    expected = _expected(count_kernel_sites(pipe.unet_cfg, T, LAT, LAT), STEPS, 1)
    requests = [
        T2VArgs(prompt="a photo of a cat in the forest", seed=1234, steps=STEPS, frames=T,
                width=256, height=256, cfg_scale=CFG),
        T2VArgs(prompt="a (bunny:1.3) in a [forest], masterpiece", seed=77, steps=STEPS,
                frames=T, width=256, height=256, cfg_scale=CFG),
    ]
    for i, args in enumerate(requests):
        launches["modelscope_24f"] = _run_request(f"ModelScope 24f request {i}", pipe, args, T,
                                                  expected)

    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    ctx = torch.randn((2, 77, pipe.unet_cfg.context_dim), generator=g, device="cuda")
    profile_unet("ModelScope", pipe.unet, T, ctx, g)

    decodes = -(-T_LONG // decode_chunk_frames(T_LONG, 256, 256))
    expected = _expected(count_kernel_sites(pipe.unet_cfg, T_LONG, LAT, LAT), STEPS_LONG, decodes)
    args = T2VArgs(prompt="a photo of a cat in the forest", seed=99, steps=STEPS_LONG,
                   frames=T_LONG, width=256, height=256, cfg_scale=CFG)
    launches["modelscope_125f"] = _run_request("ModelScope 125f request", pipe, args, T_LONG,
                                               expected)
    del pipe
    _release()
    return launches


def drive_videocrafter() -> dict:
    """Two full-width VideoCrafter requests and one UNet-call profile;
    returns the kernels' launches in one request."""
    import torch

    from t2v_torch.core.config import T2VArgs
    from t2v_torch.core.dtypes import Policy
    from t2v_torch.models.videocrafter_unet import count_vc_kernel_sites
    from t2v_torch.pipeline.videocrafter import VideoCrafterPipeline

    t0 = time.perf_counter()
    pipe = VideoCrafterPipeline.random_init(policy=Policy.bf16(), seed=0, device="cuda")
    _perturb_zero_leaves(pipe)
    n_unet = sum(p.numel() for p in pipe.unet.parameters())
    torch.cuda.synchronize()
    print(f"VideoCrafter pipeline: random_init {time.perf_counter() - t0:.1f} s, UNet "
          f"{n_unet / 1e9:.3f}B params, CLIP-L {pipe.clip_cfg.layers} layers, bf16 on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    expected = _expected(count_vc_kernel_sites(pipe.cfg, VC_T, LAT, LAT), VC_STEPS, 1)
    requests = [
        T2VArgs(prompt="a photo of a cat in the forest", n_prompt="blurry", seed=1234,
                steps=VC_STEPS, frames=VC_T, width=256, height=256, cfg_scale=CFG),
        T2VArgs(prompt="a bunny in a forest, masterpiece", seed=77, steps=VC_STEPS,
                frames=VC_T, width=256, height=256, cfg_scale=CFG),
    ]
    launches = None
    for i, args in enumerate(requests):
        launches = _run_request(f"VideoCrafter 16f request {i}", pipe, args, VC_T, expected)

    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    ctx = torch.randn((2, 77, pipe.cfg.context_dim), generator=g, device="cuda")
    profile_unet("VideoCrafter", pipe.unet, VC_T, ctx, g)
    del pipe
    _release()
    return {"videocrafter_16f": launches}


_CATEGORIES = (
    ("temporal_conv kernel", ("temporal_conv_layer_kernel",)),
    ("flash_attention kernel", ("flash_fwd_kernel",)),
    ("fused_self_mha kernel", ("packed_mha_kernel",)),
    ("fused_cross_mha kernel", ("cross_mha_kernel",)),
    ("relpos_mha kernel", ("relpos_mha_kernel",)),
    ("convolution (cuDNN)", ("conv", "fprop", "implicit", "cudnn")),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "xmma", "nvjet")),
)


def profile_unet(label, unet, frames, ctx, g) -> None:
    """Where one UNet call's device time goes: a CFG-batched call on the
    request's latent, timed with CUDA events, then once under
    torch.profiler with its kernels' device time summed by category."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn((2, frames, LAT, LAT, 4), generator=g, device="cuda")
    t = torch.full((2,), 981.0, device="cuda")
    with torch.no_grad():
        ms = _time_ms(lambda: unet(x, t, ctx), 5)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            unet(x, t, ctx)
            torch.cuda.synchronize()
    kernels = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(k[0] for k in kernels)
    n_launch = sum(k[1] for k in kernels)
    print(f"profile {label}: one UNet call (2 x {frames} frames, {LAT}x{LAT} latent) {ms:.2f} "
          f"ms by CUDA events; {n_launch} profiled kernels, {busy:.2f} ms of device time",
          flush=True)
    if busy == 0:
        print(f"profile {label}: the profiler recorded no device time (breakdown not measured)")
        return
    sums: dict[str, list] = {}
    for dev_ms, count, name in kernels:
        low = name.lower()
        cat = next((c for c, keys in _CATEGORIES if any(k in low for k in keys)),
                   "elementwise, norms, copies")
        entry = sums.setdefault(cat, [0.0, 0])
        entry[0] += dev_ms
        entry[1] += count
    for cat, (dev_ms, count) in sorted(sums.items(), key=lambda kv: -kv[1][0]):
        print(f"  {cat:28s} {dev_ms:8.2f} ms  {100 * dev_ms / busy:5.1f}%  x{count}")
    for dev_ms, count, name in sorted(kernels, reverse=True)[:10]:
        print(f"  top {dev_ms:8.2f} ms x{count:<4d} {name[:110]}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", choices=("kernels", "small", "modelscope", "videocrafter"),
                        help="run the build and one group of phases; prints no result line")
    only = parser.parse_args().only
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    if not (REPO / "t2v_torch" / "csrc").is_dir():
        print(f"chip_smoke: no t2v_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    t_start = time.perf_counter()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    build_kernels()
    records, launches = [], {}
    if only in (None, "kernels"):
        records = check_kernels()
        print(f"kernel checks done at {time.perf_counter() - t_start:.0f} s", flush=True)
    if only in (None, "small"):
        small = check_small_pipeline()
        if not all(small[k] for k in ("temporal_conv", "flash_attention", "fused_self_mha")):
            _fail(f"the small pipeline did not run every ModelScope kernel: {small}")
        small = check_small_vc_pipeline()
        if not all(small[k] for k in ("flash_attention", "fused_self_mha", "fused_cross_mha",
                                      "relpos_mha")):
            _fail(f"the small VideoCrafter pipeline did not run every kernel of its path: {small}")
        print(f"small pipelines done at {time.perf_counter() - t_start:.0f} s", flush=True)
    if only in (None, "modelscope"):
        launches.update(drive_modelscope())
        print(f"ModelScope done at {time.perf_counter() - t_start:.0f} s", flush=True)
    if only in (None, "videocrafter"):
        launches.update(drive_videocrafter())
        print(f"VideoCrafter done at {time.perf_counter() - t_start:.0f} s", flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    if only is not None:
        print(f"chip_smoke --only {only}: done; the full run prints the result line")
        return 0
    for rec in records:
        if not launches[rec.path][rec.counter]:
            _fail(f"{rec.name}: the {rec.path} path launched it no time")
    print(json.dumps({"kernels": [r.as_json(launches) for r in records]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
