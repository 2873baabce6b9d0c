"""Where a training cell's program parts from the reference, read at the
cell's own size.

    python3 benchmark/look_lora.py --workload <cell> --seeds <n> [<n> ...]

For each seed the set-up's checked steps four times over, each side keeping
every adapter leaf and its first moment after each step:

* ``ref``: the reference, float32 with TF32 off (what a run compares with);
* ``ref_bf16``: the reference with bf16-rounded operands in every product
  and convolution, gradients included: bf16 arithmetic alone, with none of
  the program's code;
* ``program``: the program as a run takes the steps (the config's dtype);
* ``program_fp32``: the program in float32 on the same values of the
  weights, TF32 off: the program's own arithmetic without bf16 (its
  activations at batch 4 may not fit the card; it then reads ``oom``).

One JSON line a seed: each step's timesteps; for each side against ``ref``
each step's relative loss gap and the change gap of the leaves ``change``
compares (``correct/lora_train.py``), worst and median leaf; and for the
program's worst leaf and for all leaves together, the share of elements
that parted (ended more than lr from the reference's), the share whose
first moment was at round-off at some step (its gap from the reference's
at least its own size), the share of parted elements among those, and the
share whose first gradient lies under ten times AdamW's eps. The
benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

EPS = 1e-8  # AdamW's, as the trainer builds it


def reference_side(cell, seed: int, device, ops) -> dict:
    from benchmark import program
    from benchmark.correct import lora_train as correct

    cfg, tr = cell.config, cell.traffic
    steps, ts = [], []

    def on_step(step, t, leaves, opt):
        ts.append([int(x) for x in t])
        steps.append({n: (p.detach().clone(), opt.state[p]["exp_avg"].detach().clone())
                      for n, p in leaves.items()})

    losses, grad1, _, _ = correct.reference_steps(cfg, tr, seed, device,
                                                  program.DTYPES[cfg["dtype"]], ops,
                                                  on_step=on_step)
    return {"losses": losses, "grad1": grad1, "steps": steps, "t": ts}


def program_side(cell, seed: int, device, dtype_name: str) -> dict:
    """The program's checked steps with the weights at the served dtype's
    values, held in ``dtype_name``."""
    from t2v_torch.parallel.train import tree_items

    from benchmark import program, weights
    from benchmark.loops import lora_train as lt

    served = program.DTYPES[cell.config["dtype"]]
    saved = weights.load_into

    @torch.no_grad()
    def load_served(module, shapes, s):
        params = dict(module.named_parameters())
        for name, t in weights.draw(shapes, s, next(iter(params.values())).device, served):
            params[name].copy_(t)

    loop = lt.Loop(dict(cell.config, dtype=dtype_name), cell.traffic, seed, device, None)
    steps = []
    unit = loop.unit

    def kept(i):
        loss = unit(i)
        state = loop.state.opt_state.state
        steps.append({n: (p.detach().clone(), state[p]["exp_avg"].detach().clone())
                      for n, p in tree_items(loop.state.params)})
        return loss

    loop.unit = kept
    weights.load_into = load_served
    try:
        loop.setup()
    finally:
        weights.load_into = saved
    out = {"losses": list(loop.checked.losses), "grad1": loop.checked.grad1, "steps": steps}
    loop.release()
    return out


def compare(side: dict, ref: dict, start: dict, moving: set, lr: float) -> dict:
    from benchmark.correct.lora_train import norm_gaps

    last, want = side["steps"][-1], ref["steps"][-1]
    names = sorted(moving)
    gaps = norm_gaps({n: last[n][0].to(want[n][0].device) - start[n] for n in names},
                     {n: want[n][0] - start[n] for n in names})
    worst = names[int(np.argmax(gaps))]

    def shares(leaves):
        parted = roundoff = both = small = total = 0
        for n in leaves:
            d = (last[n][0].to(want[n][0].device) - want[n][0]).abs() > lr
            r = torch.zeros_like(d)
            for got, exp in zip(side["steps"], ref["steps"]):
                m, mr = got[n][1].to(exp[n][1].device), exp[n][1]
                r |= (m - mr).abs() >= mr.abs()
            parted += int(d.sum())
            roundoff += int(r.sum())
            both += int((d & r).sum())
            small += int((ref["grad1"][n].abs() < 10 * EPS).sum())
            total += d.numel()
        return {"elements": total, "parted": parted / total, "roundoff": roundoff / total,
                "parted_at_roundoff": both / max(parted, 1), "grad_under_10eps": small / total}

    return {"loss": [abs(a - b) / abs(b) for a, b in zip(side["losses"], ref["losses"])],
            "change_worst": max(gaps), "change_median": float(np.median(gaps)),
            "worst_leaf": worst, "worst_leaf_elements": shares([worst]),
            "all_elements": shares(names)}


def look(cell, seed: int, device) -> dict:
    from benchmark import program
    from benchmark.correct.lora_train import SMALL
    from benchmark.loops import lora_train as lt
    from benchmark.reference.ops import Ops, strict_fp32

    tr = cell.traffic
    free = lambda: (gc.collect(), torch.cuda.empty_cache() if device.type == "cuda" else None)
    with strict_fp32():
        ref = reference_side(cell, seed, device, Ops())
        free()
        sides = {"ref_bf16": reference_side(cell, seed, device, Ops(bf16=True))}
        free()
    sides["program"] = program_side(cell, seed, device, cell.config["dtype"])
    free()
    try:
        with strict_fp32():
            sides["program_fp32"] = program_side(cell, seed, device, "float32")
    except torch.cuda.OutOfMemoryError:
        sides["program_fp32"] = None
    free()
    start = lt.draw_lora(program.param_shapes(cell.config)["unet"], tr["lora_rank"],
                         lt.seeds(seed)["lora"], device)
    start = {f"{m}.{k}": t for m, ab in start.items() for k, t in ab.items()}
    med = float(np.median([float(g.norm()) for g in ref["grad1"].values()]))
    moving = {n for n, g in ref["grad1"].items() if float(g.norm()) >= SMALL * med}
    out = {"seed": seed, "t": ref["t"], "ref_losses": ref["losses"]}
    for name, side in sides.items():
        out[name] = "oom" if side is None else compare(side, ref, start, moving, tr["lr"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ns = ap.parse_args(argv)
    from benchmark import spec
    from benchmark.run import cache_env

    cache_env(ROOT)
    cell = spec.cell(ns.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in ns.seeds:
        print(json.dumps(look(cell, seed, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
