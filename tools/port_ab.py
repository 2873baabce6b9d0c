#!/usr/bin/env python3
"""Time one tree of the PyTorch port on the GPU, for comparing two trees
(a parent commit and a change) inside one chip call.

    python3 tools/port_ab.py <tree>

``<tree>`` is a checkout (or a ``git archive``) holding ``t2v_torch/``. The
script builds its kernels, then, for full-width random-weight ModelScope
(24 frames) and VideoCrafter (16 frames) pipelines in bf16, times one
CFG-batched UNet call (three runs of five calls by CUDA events, after three
warm-up calls) with its device time from torch.profiler, and one 20-step
256x256 request after a warm-up request. It prints one ``AB`` line per
model. Run the two trees in turns, each in its own process (parent,
change, change, parent): runs in one process would share the host's state,
and two trees cannot share one import of ``t2v_torch``.
"""

from __future__ import annotations

import os
import sys
import time


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from t2v_torch.core.config import ModelScopeUNetConfig, T2VArgs
    from t2v_torch.core.dtypes import Policy
    from t2v_torch.kernels import _build
    from t2v_torch.pipeline.pipeline import ModelScopePipeline
    from t2v_torch.pipeline.videocrafter import VideoCrafterPipeline

    if not torch.cuda.is_available():
        print("port_ab: no CUDA device", file=sys.stderr)
        return 2
    _build.build(list(_build.KERNELS))

    def perturb(unet):
        with torch.no_grad():
            for p in unet.parameters():
                if not p.any():
                    p.add_(0.01)

    def measure(label, pipe, unet, frames, ctx_dim, args):
        g = torch.Generator(device="cuda").manual_seed(1)
        x = torch.randn((2, frames, 32, 32, 4), generator=g, device="cuda")
        t = torch.full((2,), 981.0, device="cuda")
        ctx = torch.randn((2, 77, ctx_dim), generator=g, device="cuda")
        with torch.no_grad():
            for _ in range(3):
                unet(x, t, ctx)
            calls = []
            for _ in range(3):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                torch.cuda.synchronize()
                start.record()
                for _ in range(5):
                    unet(x, t, ctx)
                end.record()
                torch.cuda.synchronize()
                calls.append(start.elapsed_time(end) / 5)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                unet(x, t, ctx)
                torch.cuda.synchronize()
        device = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA) / 1e3
        pipe.infer(args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.infer(args)
        torch.cuda.synchronize()
        video = time.perf_counter() - t0
        print(f"AB {root} {label}: UNet call {', '.join(f'{m:.2f}' for m in calls)} ms by CUDA "
              f"events, {device:.2f} ms of device time; {video:.3f} s/video",
              flush=True)

    pipe = ModelScopePipeline.random_init(ModelScopeUNetConfig(), Policy.bf16(), seed=0)
    perturb(pipe.unet)
    measure("ModelScope 24f", pipe, pipe.unet, 24, pipe.unet_cfg.context_dim,
            T2VArgs(prompt="a photo of a cat in the forest", seed=1, steps=20, frames=24,
                    width=256, height=256, cfg_scale=9.0))
    del pipe
    torch.cuda.empty_cache()
    vc = VideoCrafterPipeline.random_init(policy=Policy.bf16(), seed=0)
    perturb(vc.unet)
    measure("VideoCrafter 16f", vc, vc.unet, 16, vc.cfg.context_dim,
            T2VArgs(prompt="a photo of a cat in the forest", seed=1, steps=20, frames=16,
                    width=256, height=256, cfg_scale=9.0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
