"""Tracing and run provenance of the port.

The port's counterpart of the JAX package's ``core/profiling.py``:
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
from dataclasses import dataclass, field
from typing import Any


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
