#!/usr/bin/env python3
"""Time one tree's flash-attention backward kernels on the GPU, for comparing
two trees (a parent commit and a change) inside one chip call.

    python3 tools/flash_bwd_ab.py <tree>

``<tree>`` is a checkout (or a ``git archive``) holding ``t2v_torch/``. The
script builds its two flash sources, then at the training path's two shapes
(ModelScope's 32x32 self-attention of a 16-frame step, (80, 1024, 1024, 64),
and VideoCrafter's, (128, 1024, 1024, 40)) times ``flash_attention_bwd_dkv``
and ``flash_attention_bwd_dq`` on the same seeded bf16 inputs: three runs of
ten calls by CUDA events after two warm-up calls, and the kernels' device
time from torch.profiler over five calls. It prints one ``AB`` line per
shape. Run the trees in turns, each in its own process (parent, change,
change, parent): two trees cannot share one import of ``t2v_torch``.
"""

from __future__ import annotations

import os
import sys

SHAPES = [(80, 1024, 1024, 64), (128, 1024, 1024, 40)]


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from t2v_torch.kernels import _build
    from t2v_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    _build.build(["flash_attention", "flash_attention_bwd"])

    def events_ms(call) -> list[float]:
        for _ in range(2):
            call()
        runs = []
        for _ in range(3):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            for _ in range(10):
                call()
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end) / 10)
        return runs

    def device_ms(call, kernel: str) -> float:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and kernel in e.key) / 1e3 / 5

    g = torch.Generator(device="cuda").manual_seed(7)
    for b, n, s, d in SHAPES:
        scale = d ** -0.5
        q, do = (torch.randn((b, n, d), generator=g, device="cuda").to(torch.bfloat16)
                 for _ in range(2))
        k, v = (torch.randn((b, s, d), generator=g, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        o, lse = fa.flash_attention_fwd(q, k, v, scale)
        args = (q, k, v, do, lse, fa.bwd_delta(o, do), scale)
        parts = []
        for name, call in (("dkv", lambda: fa.flash_attention_bwd_dkv(*args)),
                           ("dq", lambda: fa.flash_attention_bwd_dq(*args))):
            runs = events_ms(call)
            dev = device_ms(call, f"flash_bwd_{name}_kernel")
            parts.append(f"{name} {', '.join(f'{m:.4f}' for m in runs)} ms by CUDA events, "
                         f"{dev:.4f} ms of device time")
        print(f"AB {root} {(b, n, s, d)}: " + "; ".join(parts), flush=True)
        del q, k, v, do, o, lse, args
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
