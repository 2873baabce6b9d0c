#!/usr/bin/env python3
"""Time one tree's rel-pos temporal attention kernel on the GPU, for
comparing two trees (a parent commit and a change) inside one chip call.

    python3 tools/relpos_ab.py <tree>

``<tree>`` is a checkout (or a ``git archive``) holding ``t2v_torch/``. The
script builds its ``relpos_mha`` source, then at VideoCrafter's four
temporal-attention shapes (16 frames of CFG batch 2 at 32x32, 16x16, 8x8
and 4x4 tokens; 8 heads of 40, 80, 160 and 160) holds ``relpos_mha``
against ``relpos_mha_plain`` on the same seeded bf16 inputs and times it:
three runs of twenty calls by CUDA events after two warm-up calls, the
kernel's device time from torch.profiler over five calls, and the
wrapper's host time a call. It prints one ``AB`` line per shape. Run the
trees in turns, each in its own process (parent, change, change, parent):
two trees cannot share one import of ``t2v_torch``.
"""

from __future__ import annotations

import os
import sys
import time

# (B, T, N, heads, D)
SHAPES = [(2, 16, 1024, 8, 40), (2, 16, 256, 8, 80), (2, 16, 64, 8, 160), (2, 16, 16, 8, 160)]


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from t2v_torch.kernels import _build
    from t2v_torch.kernels.relpos_mha import relpos_mha, relpos_mha_plain

    if not torch.cuda.is_available():
        print("relpos_ab: no CUDA device", file=sys.stderr)
        return 2
    _build.build(["relpos_mha"])

    def events_ms(call) -> list[float]:
        for _ in range(2):
            call()
        runs = []
        for _ in range(3):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            for _ in range(20):
                call()
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end) / 20)
        return runs

    def device_ms(call) -> float:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and "relpos_mha_kernel" in e.key) / 1e3 / 5

    def host_us(call) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            call()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        return 1e6 * host / 20

    g = torch.Generator(device="cuda").manual_seed(7)
    for b, t, n, h, d in SHAPES:
        q, k, v = (torch.randn((b * t, n, h * d), generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        k2, v2 = (torch.randn((t, t, d), generator=g, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        call = lambda: relpos_mha(q, k, v, k2, v2, h, t)  # noqa: E731
        err = (call().float() - relpos_mha_plain(q, k, v, k2, v2, h, t).float()).abs().max().item()
        runs = events_ms(call)
        dev = device_ms(call)
        print(f"AB {root} {(b * t, n, h * d, h)}: {', '.join(f'{m:.4f}' for m in runs)} ms by "
              f"CUDA events, {dev:.4f} ms of device time, host {host_us(call):.1f} us a call; "
              f"max abs error against the plain version {err:.3e}", flush=True)
        del q, k, v, k2, v2
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
