"""Tracing and run provenance of the port.

The port's counterpart of the JAX package's ``core/profiling.py``:
  * ``span(name)``  — a ``torch.profiler.record_function`` range while a
    profiler records, and a shared no-op context otherwise (one flag test):
    the port's layers open ``t2v.*`` spans (request phases, sampler steps,
    UNet calls and blocks, the VAE encode, training phases) that land on
    the profiler's clock beside the kernels they launch;
  * ``PhaseTimes``  — host seconds per named phase (text encode, sample,
    decode, emit), summed over every entry of the phase; each phase is
    also the span ``t2v.<phase>``;
  * ``trace(dir)``  — a ``torch.profiler`` trace (host and, on the card,
    device activity, with the spans) written to ``dir`` as a Chrome trace;
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

import torch
from torch.autograd import profiler as _autograd_profiler


class _Off:
    """The context ``span`` returns with no profiler: methods of fixed arity,
    cheaper to enter and leave than ``contextlib.nullcontext``."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()


def span(name: str, args: str | None = None):
    """A ``record_function(name, args)`` range while a ``torch.profiler``
    records (the CLI's ``--profile``, a benchmark's trace), else a shared
    no-op context: one test of the profiler's own flag, no synchronize, no
    host copy, no device allocation."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name, args)


@dataclass
class PhaseTimes:
    """Host seconds per named phase, summed over the phase's entries (also
    when the body raises); each entry is the span ``t2v.<name>``. A phase
    that runs work on the card should end in a synchronize, or the time is
    the enqueue's."""

    times: dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            with span("t2v." + name):
                yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def add(self, times: dict[str, float]) -> None:
        """Sum another record's phases (a request's ``timings``) into this one."""
        for name, s in times.items():
            self.times[name] = self.times.get(name, 0.0) + s

    def summary(self) -> str:
        return " ".join(f"{k}={v:.2f}s" for k, v in self.times.items())


@contextlib.contextmanager
def trace(trace_dir: str | None):
    """torch.profiler scope over the CPU and, where there is one, the card;
    writes ``trace.json`` into ``trace_dir``. A no-op when it is None."""
    if not trace_dir:
        yield
        return
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
