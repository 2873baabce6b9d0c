"""Read the correctness control of a request cell at the cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

The control is the plain reference with every operand of its matrix
products and convolutions rounded to float8 e4m3 (``Ops(fp8=True)``), put in
the program's place: for each seed it answers the units that a run of the
cell with that seed would capture, with its own sampling chain, and the
float32 reference judges those answers as it judges the program's. Prints
one JSON line per seed with each compared number beside the cell's limit;
every seed must fail at least one limit. The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_readings(cell, seed: int, device) -> dict:
    """The compared numbers of the control on the units a run with ``seed``
    would capture (the set-up's checked steps of a training cell)."""
    import torch

    from benchmark import program
    from benchmark.correct import lora_train
    from benchmark.correct import request as correct
    from benchmark.loops.request import videos
    from benchmark.reference.ops import Ops, strict_fp32
    from benchmark.reference.text import Tokenizer
    from benchmark.run import captured_units

    cfg, tr = cell.config, cell.traffic
    dtype = program.DTYPES[cfg["dtype"]]
    if tr["loop"] == "lora_train":
        sd = program.reference_weights(cfg, seed, device, dtype)
        cap = lora_train.control(cfg, tr, seed, device, dtype, sd)
        with strict_fp32():
            out = lora_train.judge(cfg, tr, cap, seed, device, dtype, Ops(), sd)
        out.pop("notes", None)
        return out
    tok = Tokenizer(cfg["tokenizer"]["merge_words"])
    units = [videos(tr, tok, seed, i) for i in captured_units(cell, seed)]
    sd = program.reference_weights(cfg, seed, device, dtype)
    caps = correct.control(cfg, tr, units, seed, device, dtype, sd)
    with strict_fp32():
        ref = correct.Reference(cfg, seed, device, dtype, Ops(), sd)
        out = correct.judge(ref, tr, caps, seed, cell.check["check"]["calls"])
    out.pop("notes")
    del sd, caps
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ns = ap.parse_args(argv)
    import torch

    from benchmark import spec

    cell = spec.cell(ns.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    limits = cell.check["limits"]
    for seed in ns.seeds:
        t0 = time.perf_counter()
        nums = control_readings(cell, seed, device)
        failed = [k for k, v in nums.items() if v > limits[k]]
        print(json.dumps({"workload": ns.workload, "seed": seed, "failed": failed,
                          "seconds": round(time.perf_counter() - t0, 1),
                          "readings": {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
