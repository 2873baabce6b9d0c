"""A loop and a check that stand in for a cell's own, for the rank
plumbing's test (``test_bench_ranks.py``; a traffic's ``loop`` names this
module): each unit prints the rank on standard output and takes one
collective, each rank reads the memory peak ``PEAKS`` gives it (rank 1 the
larger), and the check reports one number. The rank that the traffic's
``flax_on_rank`` names puts a module named ``flax`` in ``sys.modules``."""

from __future__ import annotations

import sys
import types

import torch
import torch.distributed as dist

from benchmark import run, spans

PEAKS = (3 << 30, 5 << 30)  # the memory peak each rank reads, in bytes


class Loop:
    def __init__(self, cfg, traffic, run_seed, device, peaks):
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        if traffic.get("flax_on_rank") == self.rank:
            sys.modules.setdefault("flax", types.ModuleType("flax"))
        run.memory_peak = lambda device: PEAKS[self.rank]
        self.timer, self.annot = spans.Timer(), spans.Annotator(peaks)
        self.capture = None
        self.setup_captures: list = []
        self.counting = True

    def setup(self):
        self.unit(0)

    def reset(self):
        self.counting = True

    def new_capture(self):
        return []

    def unit(self, i: int) -> int:
        print(f"stub rank {self.rank} unit {i}", flush=True)
        t = torch.ones(1)
        if dist.is_initialized():
            dist.all_reduce(t)
        return 1

    def gathered(self, captures: list) -> list:
        return captures

    def release(self):
        pass


def check(cfg, traffic, captures, run_seed, device, dtype, check_spec) -> dict:
    return {"stub": 0.0}
