#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``t2v_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. build every CUDA kernel of the main path from ``t2v_torch/csrc`` (one
   ``nvcc`` per source, all started together) and print the build time;
2. check that each wrapper refuses malformed CUDA tensors, then hold each
   kernel against its plain PyTorch version on the card, in bf16, at every
   shape the main path gives it plus a ragged one; print the max error
   against the stated tolerance and the kernel's, the plain version's and
   one library call's time (the library call is timed here as a yardstick
   only: the port never calls it);
3. answer one request with a small pipeline whose widths every kernel
   takes, in bf16 on the card, and hold its latents and frames against the
   same weights in float32 on the CPU (``check_small_pipeline``);
4. build ``ModelScopePipeline.random_init`` at the full configs (1.41B-
   parameter UNet, ViT-H text tower, SD VAE) in bf16 on the card, perturb
   the zero-initialised leaves, and answer two txt2vid requests (24 frames at
   256x256, 20 DDIM_Gaussian steps, CFG 9). For each, print the seconds
   per phase, the peak memory, the frames' shape, dtype and finiteness,
   and each kernel's launch count, which must equal the count the UNet
   topology predicts;
5. time one UNet call and break its device time down by kernel category
   with torch.profiler;
6. print the card's name and power limit, one ``{"kernels": [...]}`` line,
   and as the last line ``{"ok": true, "device": {...}}``.

It exits non-zero without a GPU, and in a directory without the port.
"""

from __future__ import annotations

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

T = 24            # frames
LAT = 32          # 256 px / 8
STEPS = 20
CFG = 9.0


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


class KernelRecord:
    def __init__(self, name, source, replaces):
        self.name, self.source, self.replaces = name, source, replaces
        self.max_abs_err = 0.0
        self.main = None  # timings at the main path's dominant shape

    def timed(self, shape, ms, plain_ms, library_ms, flops, nbytes, main=False) -> None:
        """Print one launch's time at ``shape`` beside its bound, the plain
        version's and the library call's; keep it for the JSON line when it
        is the main path's dominant shape."""
        bound, by = _bound_ms(flops, nbytes)
        print(f"  time {self.name:16s} {str(tuple(shape)):24s} kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound {bound:.4f} ms ({by})",
              flush=True)
        if main:
            self.main = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                         "library_ms": library_ms, "shape": list(shape)}

    def as_json(self, launches: int) -> dict:
        return {"name": self.name, "route": "cuda", "source": self.source,
                "replaces": self.replaces, "launches": launches,
                "max_abs_err": self.max_abs_err, **self.main}


def _compare(rec: KernelRecord, label: str, got, want) -> None:
    import torch

    if not torch.isfinite(got).all():
        _fail(f"{rec.name} {label}: kernel output is not finite")
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    rel = err / scale
    ok = err <= TOL_SHARE * scale
    print(f"  {rec.name:16s} {label:34s} max_abs_err={err:.3e} rel={rel:.3e} "
          f"tol={TOL_SHARE * scale:.3e} {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        _fail(f"{rec.name} {label}: max abs error {err} above {TOL_SHARE * scale}")
    rec.max_abs_err = max(rec.max_abs_err, err)


def check_temporal_conv(g) -> KernelRecord:
    import torch

    from t2v_torch.kernels import temporal_conv as tc

    rec = KernelRecord("temporal_conv", "t2v_torch/csrc/temporal_conv.cu",
                       "t2v/kernels/temporal_conv.py:197")
    dev = "cuda"
    # (B, F, HW, C): the four UNet levels at 24 frames with CFG, a ragged one
    ragged = (1, 5, 37, 128)
    shapes = [(2, T, 1024, 320), (2, T, 256, 640), (2, T, 64, 1280), (2, T, 16, 1280), ragged]
    for b, f, hw, c in shapes:
        x = torch.randn((b, f, hw, c), generator=g, device=dev).to(torch.bfloat16)
        layers = []
        for _ in range(4):
            layers.append((
                1.0 + 0.1 * torch.randn((c,), generator=g, device=dev),
                0.1 * torch.randn((c,), generator=g, device=dev),
                (torch.randn((3, c, c), generator=g, device=dev) / math.sqrt(3 * c)).to(torch.bfloat16),
                (0.1 * torch.randn((c,), generator=g, device=dev)).to(torch.bfloat16),
            ))
        got = tc.temporal_conv_chain(x, layers)
        want = tc.chain_plain(x, layers)
        torch.cuda.synchronize()
        _compare(rec, f"chain x{tuple(x.shape)}", got, want)
        if (b, f, hw, c) == ragged:  # checked, not timed
            continue
        # one stats-emitting layer (three of every four launches); the
        # library yardstick is one matmul of the pre-activated, frame-shifted
        # input (B*F*HW, 3C) by the stacked taps (3C, C)
        fin = tc.finalize_stats(tc.input_stats(x), f * hw, 1e-5)
        s, bias, w, cb = layers[0]
        ms = _time_ms(lambda: tc.temporal_conv_layer(x, fin, s, bias, w, cb), 20)
        plain_ms = _time_ms(lambda: tc.layer_plain(x, fin, s, bias, w, cb), 5)
        a = torch.nn.functional.silu((x.float() - fin[:, 0, None, None]) * fin[:, 1, None, None])
        a = torch.nn.functional.pad(a.to(torch.bfloat16), (0, 0, 0, 0, 1, 1))
        a_cat = torch.cat([a[:, k:k + f] for k in range(3)], dim=-1).reshape(-1, 3 * c)
        w_cat = w.reshape(3 * c, c)
        lib_ms = _time_ms(lambda: torch.matmul(a_cat, w_cat), 20)
        m = b * f * hw
        rec.timed((b, f, hw, c), ms, plain_ms, lib_ms, 2.0 * m * 3 * c * c,
                  2 * m * c * 2 + 3 * c * c * 2, main=(hw, c) == (1024, 320))
    return rec


def _attn_flops_bytes(b, n, s, d, heads=1):
    return 4.0 * b * heads * n * s * d, 2.0 * b * heads * d * (2 * n + 2 * s)


def check_flash(g) -> KernelRecord:
    import torch
    import torch.nn.functional as F

    from t2v_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    rec = KernelRecord("flash_attention", "t2v_torch/csrc/flash_attention.cu",
                       "t2v/kernels/flash_attention.py:33")
    # (B, N, S, D, scale): UNet 32x32 spatial self-attention (2 x 24 frames x
    # 5 heads), the VAE mid-block attention, and a ragged one
    ragged = (3, 333, 777, 64, 0.125)
    cases = [(240, 1024, 1024, 64, 0.125), (24, 1024, 1024, 512, 512 ** -0.5), ragged]
    for b, n, s, d, scale in cases:
        q = torch.randn((b, n, d), generator=g, device="cuda").to(torch.bfloat16)
        k = torch.randn((b, s, d), generator=g, device="cuda").to(torch.bfloat16)
        v = torch.randn((b, s, d), generator=g, device="cuda").to(torch.bfloat16)
        got = flash_attention(q, k, v, scale)
        want = flash_attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        _compare(rec, f"q{(b, n, d)} kv{(b, s, d)}", got, want)
        if (b, n, s, d, scale) == ragged:  # checked, not timed
            continue
        ms = _time_ms(lambda: flash_attention(q, k, v, scale), 10)
        plain_ms = _time_ms(lambda: flash_attention_plain(q, k, v, scale), 5)
        # SDPA takes its fused paths on 4-D (batch, heads, seq, dim) input
        q4, k4, v4 = q[:, None], k[:, None], v[:, None]
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale), 10)
        rec.timed((b, n, s, d), ms, plain_ms, lib_ms, *_attn_flops_bytes(b, n, s, d),
                  main=d == 64)
    return rec


def check_fused_mha(g) -> KernelRecord:
    import torch
    import torch.nn.functional as F

    from t2v_torch.kernels.fused_mha import fused_self_mha, fused_self_mha_plain

    rec = KernelRecord("fused_self_mha", "t2v_torch/csrc/fused_mha.cu",
                       "t2v/kernels/fused_mha.py:52")
    # (B, N, heads) at head dim 64: spatial self-attention at 16x16, 8x8 and
    # 4x4, temporal self-attention over 24 frames at every level, a ragged one
    ragged = (7, 13, 3)
    cases = [(48, 256, 10), (48, 64, 20), (48, 16, 20), (2048, 24, 5), (2048, 24, 8),
             (512, 24, 10), (128, 24, 20), (32, 24, 20), ragged]
    for b, n, h in cases:
        hd = h * 64
        q, k, v = (torch.randn((b, n, hd), generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        got = fused_self_mha(q, k, v, h)
        want = fused_self_mha_plain(q, k, v, h)
        torch.cuda.synchronize()
        _compare(rec, f"x{(b, n, hd)} heads={h}", got, want)
        if (b, n, h) == ragged:  # checked, not timed
            continue
        fold = lambda t: t.view(b, n, h, 64).transpose(1, 2)
        ms = _time_ms(lambda: fused_self_mha(q, k, v, h), 20)
        plain_ms = _time_ms(lambda: fused_self_mha_plain(q, k, v, h), 5)
        lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(fold(q), fold(k), fold(v)), 20)
        rec.timed((b, n, hd, h), ms, plain_ms, lib_ms, *_attn_flops_bytes(b, n, n, 64, h),
                  main=(b, n, h) == (48, 256, 10))
    return rec


def build_kernels() -> float:
    from t2v_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build(list(_build.KERNELS))
    secs = time.perf_counter() - t0
    for name, log in logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"  {name}: " + (" | ".join(regs[:4]) if regs else "(built before)"), flush=True)
    print(f"build: {secs:.1f} s for {len(logs)} kernels", flush=True)
    return secs


def check_refusals() -> None:
    """Each wrapper raises ValueError on a CUDA tensor its kernel does not
    take (wrong dtype, shape or contiguity), and launches nothing."""
    import torch

    from t2v_torch.kernels import flash_attention, fused_mha, temporal_conv

    def bf16(*shape):
        return torch.zeros(shape, device="cuda", dtype=torch.bfloat16)

    c = 64
    vec = torch.zeros(c, device="cuda")
    fin = torch.zeros(2, 2, c, device="cuda")
    w = bf16(3, c, c)
    q = bf16(2, 24, 2 * 64)
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
        "fused_self_mha strided": lambda: fused_mha.fused_self_mha(
            *(bf16(2, 128, 24).transpose(1, 2),) * 3, 2),
    }
    counters = (temporal_conv.COUNTER, flash_attention.COUNTER, fused_mha.COUNTER)
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
        return [check_temporal_conv(g), check_flash(g), check_fused_mha(g)]


def _models(pipe):
    return pipe.unet, pipe.vae, pipe.text_encoder.model


def _perturb_zero_leaves(pipe) -> None:
    """Add 0.01 to every all-zero parameter: the zero-initialised gates of a
    random-weight pipeline would make every UNet output 0."""
    import torch

    with torch.no_grad():
        for mod in _models(pipe):
            for p in mod.parameters():
                if not p.any():
                    p.add_(0.01)


def _counters():
    from t2v_torch.kernels import flash_attention, fused_mha, temporal_conv

    return {"temporal_conv": temporal_conv.COUNTER, "flash_attention": flash_attention.COUNTER,
            "fused_self_mha": fused_mha.COUNTER}


# a small pipeline whose widths every kernel takes (channels a multiple of
# 64, 64-wide heads): at 64x64 px (a 32x32 latent under its two-level VAE)
# its 1,024-token attention goes to flash and the rest to the packed kernel
SMALL_UNET = dict(dim=64, context_dim=64, dim_mult=(1, 2), num_res_blocks=1, num_heads=1,
                  head_dim=64, attn_scales=(1.0, 0.5))
# the card's bf16 run may be at most this many times as far from the float32
# reference as the plain bf16 run on the CPU: both round at the same points
# and differ in summation order, so their distances are of one size
SMALL_RATIO = 2.0


def check_small_pipeline(device: str = "cuda") -> dict:
    """The whole main path on a small input against a float32 reference.

    One seeded small pipeline answers one request (8 frames at 64x64, 4
    DDIM_Gaussian steps, CFG 9) from the same starting noise three times:
    float32 on the CPU (the reference), bf16 on the CPU (the plain versions:
    the distance bf16 alone makes), and bf16 on ``device`` (the kernels).
    Fails when the last is more than SMALL_RATIO times as far from the
    reference as the second, in relative RMS of the final latents and of
    the uint8 frames. Returns the kernels' launches in the ``device`` run.
    """
    import torch

    from t2v_torch.core.config import ModelScopeUNetConfig, T2VArgs
    from t2v_torch.core.dtypes import Policy
    from t2v_torch.pipeline.pipeline import ModelScopePipeline

    cfg = ModelScopeUNetConfig(**SMALL_UNET)
    ref = ModelScopePipeline.random_init(cfg, Policy.fp32(), seed=0, device="cpu")
    _perturb_zero_leaves(ref)

    def copy(policy, dev):
        pipe = ModelScopePipeline.random_init(cfg, policy, seed=0, device=dev)
        for dst, src in zip(_models(pipe), _models(ref)):
            dst.load_state_dict(src.state_dict())
        return pipe

    args = T2VArgs(prompt="a (red:1.2) fox running in the snow", seed=3, steps=4, frames=8,
                   width=64, height=64, cfg_scale=CFG)
    g = torch.Generator().manual_seed(3)
    noise = torch.randn((1, 8, 32, 32, 4), generator=g)
    want = ref.infer(args, noise=noise)
    cpu16 = copy(Policy.bf16(), "cpu").infer(args, noise=noise)
    pipe = copy(Policy.bf16(), device)
    for c in _counters().values():
        c.reset()
    got = pipe.infer(args, noise=noise)
    launches = {k: c.count for k, c in _counters().items()}

    def rel(a, b) -> float:
        a, b = torch.as_tensor(a).double().cpu(), torch.as_tensor(b).double().cpu()
        return ((a - b).norm() / b.norm()).item()

    for what, pick in (("latents", lambda r: r.latents), ("frames", lambda r: r.frames)):
        err, floor = rel(pick(got), pick(want)), rel(pick(cpu16), pick(want))
        ok = err <= SMALL_RATIO * floor
        print(f"small pipeline {what}: bf16 on {device} {err:.3e} from the float32 reference, "
              f"bf16 on cpu {floor:.3e}, limit {SMALL_RATIO * floor:.3e} "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            _fail(f"small pipeline {what}: {err} from the reference, above {SMALL_RATIO} x {floor}")
    print(f"small pipeline launches on {device}: {launches}", flush=True)
    return launches


def drive_pipeline():
    """Two full-width requests; returns the pipeline and the kernels'
    launches in one request."""
    import numpy as np
    import torch

    from t2v_torch.core.config import ModelScopeUNetConfig, T2VArgs
    from t2v_torch.core.dtypes import Policy
    from t2v_torch.models.modelscope_unet import count_kernel_sites
    from t2v_torch.pipeline.pipeline import ModelScopePipeline

    t0 = time.perf_counter()
    pipe = ModelScopePipeline.random_init(ModelScopeUNetConfig(), Policy.bf16(), seed=0,
                                          device="cuda")
    _perturb_zero_leaves(pipe)
    n_unet = sum(p.numel() for p in pipe.unet.parameters())
    torch.cuda.synchronize()
    print(f"pipeline: random_init {time.perf_counter() - t0:.1f} s, UNet {n_unet / 1e9:.3f}B "
          f"params, bf16 on {torch.cuda.get_device_name(0)}", flush=True)

    per_call = count_kernel_sites(pipe.unet_cfg, T, LAT, LAT)
    expected = {"temporal_conv": STEPS * per_call["temporal_conv"],
                "flash_attention": STEPS * per_call["flash_attention"] + 1,  # + VAE mid attention
                "fused_self_mha": STEPS * per_call["fused_self_mha"]}
    counters = _counters()
    requests = [
        T2VArgs(prompt="a photo of a cat in the forest", seed=1234, steps=STEPS, frames=T,
                width=256, height=256, cfg_scale=CFG),
        T2VArgs(prompt="a (bunny:1.3) in a [forest], masterpiece", seed=77, steps=STEPS,
                frames=T, width=256, height=256, cfg_scale=CFG),
    ]
    launches = None
    for i, args in enumerate(requests):
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        res = pipe.infer(args)
        total = time.perf_counter() - t0
        counts = {k: c.count for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        fr = res.frames
        finite = bool(np.isfinite(res.latents.cpu().numpy()).all())
        tm = res.timings
        print(f"request {i}: {total:.3f} s/video (text {tm['text']:.3f}, sample "
              f"{tm['sample']:.3f}, decode {tm['decode']:.3f}), peak {peak:.2f} GiB, frames "
              f"{fr.shape} {fr.dtype}, latents finite={finite}, frame mean {fr.mean():.2f} "
              f"std {fr.std():.2f}, launches {counts}", flush=True)
        if fr.shape != (T, 256, 256, 3) or fr.dtype != np.uint8:
            _fail(f"frames {fr.shape} {fr.dtype}, expected ({T}, 256, 256, 3) uint8")
        if not finite:
            _fail("latents are not finite")
        if counts != expected:
            _fail(f"launch counts {counts} differ from the topology's {expected}")
        launches = counts
    return pipe, launches


_CATEGORIES = (
    ("temporal_conv kernel", ("temporal_conv_layer_kernel",)),
    ("flash_attention kernel", ("flash_fwd_kernel",)),
    ("fused_self_mha kernel", ("self_mha_kernel",)),
    ("convolution (cuDNN)", ("conv", "fprop", "implicit", "cudnn")),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "xmma", "nvjet")),
)


def profile_unet(pipe) -> None:
    """Where one UNet call's device time goes: a CFG-batched call on the
    main path's latent, timed with CUDA events, then once under
    torch.profiler with its kernels' device time summed by category."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    x = torch.randn((2, T, LAT, LAT, 4), generator=g, device="cuda")
    t = torch.full((2,), 981.0, device="cuda")
    ctx = torch.randn((2, 77, pipe.unet_cfg.context_dim), generator=g, device="cuda")
    with torch.no_grad():
        ms = _time_ms(lambda: pipe.unet(x, t, ctx), 5)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pipe.unet(x, t, ctx)
            torch.cuda.synchronize()
    kernels = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(k[0] for k in kernels)
    print(f"profile: one UNet call (2 x {T} frames, {LAT}x{LAT} latent) {ms:.2f} ms by CUDA "
          f"events; profiled kernels {busy:.2f} ms of device time", flush=True)
    if busy == 0:
        print("profile: the profiler recorded no device time (breakdown not measured)")
        return
    sums: dict[str, float] = {}
    for dev_ms, _, name in kernels:
        low = name.lower()
        cat = next((c for c, keys in _CATEGORIES if any(k in low for k in keys)),
                   "elementwise, norms, copies")
        sums[cat] = sums.get(cat, 0.0) + dev_ms
    for cat, dev_ms in sorted(sums.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:28s} {dev_ms:8.2f} ms  {100 * dev_ms / busy:5.1f}%")
    for dev_ms, count, name in sorted(kernels, reverse=True)[:12]:
        print(f"  top {dev_ms:8.2f} ms x{count:<4d} {name[:110]}")


def main() -> int:
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
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    build_kernels()
    records = check_kernels()
    small = check_small_pipeline()
    if not all(small.values()):
        _fail(f"the small pipeline did not run every kernel: {small}")
    pipe, launches = drive_pipeline()
    profile_unet(pipe)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"kernels": [r.as_json(launches[r.name]) for r in records]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
