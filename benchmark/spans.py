"""Spans that the benchmark puts around calls into the program's layers.

Forward hooks on the program's modules, installed from outside (the program
is not edited):

* ``Timer``: a pair of CUDA events around every call of a module while
  ``on`` is set; ``mean_ms`` reads them once the device has finished;
* ``Annotator``: a ``torch.profiler.record_function`` range around every
  call while ``on`` is set, so that the profiler's trace shows which
  kernels each layer launched, and the least time of each call's work
  (``benchmark/work/layers.py``) summed by span name.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch


def hook(module: torch.nn.Module, pre, post) -> list:
    """Register ``pre(module, args, kwargs)`` and ``post(module, args, kwargs,
    out)`` on ``module``; returns the handles."""
    return [module.register_forward_pre_hook(pre, with_kwargs=True),
            module.register_forward_hook(post, with_kwargs=True)]


class Timer:
    def __init__(self):
        self.on = False
        self.pairs: dict[str, list] = defaultdict(list)
        self._open: list = []
        self.handles: list = []

    def watch(self, module: torch.nn.Module, name: str) -> None:
        def pre(mod, args, kwargs):
            if self.on:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self._open.append(ev)

        def post(mod, args, kwargs, out):
            if self.on and self._open:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.pairs[name].append((self._open.pop(), ev))

        self.handles += hook(module, pre, post)

    def mean_ms(self, name: str) -> float | None:
        pairs = self.pairs.get(name)
        if not pairs:
            return None
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / len(pairs)


class Annotator:
    def __init__(self, peaks: dict | None):
        self.on = False
        self.peaks = peaks
        self.least_s: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)
        self._open: list = []
        self.handles: list = []

    def watch(self, module: torch.nn.Module, name: str, work=None) -> None:
        """``work(module, args, kwargs)`` -> ``Work`` of one call, or None."""
        def pre(mod, args, kwargs):
            if not self.on:
                return
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            self._open.append(rf)
            self.calls[name] += 1
            if work is not None and self.peaks is not None:
                self.least_s[name] += work(mod, args, kwargs).least_s(self.peaks)

        def post(mod, args, kwargs, out):
            if self.on and self._open:
                self._open.pop().__exit__(None, None, None)

        self.handles += hook(module, pre, post)

    def span(self, name: str):
        """A ``record_function`` range for a call that is not a module's."""
        return torch.profiler.record_function(name) if self.on else contextlib.nullcontext()


def remove(handles) -> None:
    for h in handles:
        h.remove()
