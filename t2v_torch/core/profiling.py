"""Tracing and run provenance of the port.

The port's counterpart of the JAX package's ``core/profiling.py``:
  * ``PhaseTimes``  — host seconds per named phase (text encode, sample,
    decode, stitch), summed over every entry of the phase;
  * ``trace(dir)``  — a ``torch.profiler`` trace (host and, on the card,
    device activity) written to ``dir`` as a Chrome trace;
  * ``RunManifest`` — the machine-readable record written next to each
    batch's outputs, beside the human-readable ``args.txt``. It records
    torch's version and the device the run used where the JAX package
    records its backend and device count.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any


@dataclass
class PhaseTimes:
    """Host seconds per named phase, summed over the phase's entries. A
    phase that runs work on the card should end in a synchronize, or the
    time is the enqueue's."""

    times: dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def summary(self) -> str:
        return " ".join(f"{k}={v:.2f}s" for k, v in self.times.items())


@contextlib.contextmanager
def trace(trace_dir: str | None):
    """torch.profiler scope over the CPU and, where there is one, the card;
    writes ``trace.json`` into ``trace_dir``. A no-op when it is None."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


@dataclass
class RunManifest:
    """Machine-readable generation record (one per batch output dir)."""

    prompt: str = ""
    n_prompt: str = ""
    sampler: str = ""
    steps: int = 0
    frames: int = 0
    seed: int = 0
    cfg_scale: float = 0.0
    width: int = 0
    height: int = 0
    model: str = ""
    model_type: str = ""
    eta: float = 0.0
    strength: float | None = None
    framework_version: str = ""
    torch_version: str = ""
    device: str = ""
    phase_times: dict[str, float] = field(default_factory=dict)
    extra: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_args(cls, args, *, seed: int, device="cpu",
                  phase_times: dict | None = None) -> "RunManifest":
        import torch

        import t2v_torch

        dev = torch.device(device)
        return cls(
            prompt=args.prompt,
            n_prompt=args.n_prompt,
            sampler=args.sampler,
            steps=args.steps,
            frames=args.frames,
            seed=seed,
            cfg_scale=args.cfg_scale,
            width=args.width,
            height=args.height,
            model=str(args.model),
            model_type=args.model_type,
            eta=args.eta,
            strength=args.strength if args.do_vid2vid else None,
            framework_version=t2v_torch.__version__,
            torch_version=torch.__version__,
            device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
            phase_times=dict(phase_times or {}),
        )

    def write(self, out_dir: str, name: str = "manifest.json") -> str:
        path = os.path.join(out_dir, name)
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)
        return path
