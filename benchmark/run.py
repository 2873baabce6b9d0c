"""Run one cell of the port's benchmark and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port (``t2v_torch``). One run:

1. set-up (``setup_s``): imports, the kernels built or loaded (into
   ``t2v_torch/_build/`` inside the checkout), the pipeline built with
   weights drawn on the card from ``--seed``, every shape of the cell warmed
   by one short unit;
2. the window: whole units (requests, batches or training steps) one after
   another until ``--seconds`` have passed; the units the cell's check names
   (drawn from the seed) are captured for the correctness check (a training
   cell's checked steps are its set-up's first steps);
3. with ``--trace 1``, the traffic's ``trace_units`` more units under a
   profiler of the device alone (``busy_s``, ``window_s``, ``device_idle``),
   then as many under ``torch.profiler`` with the host's operators and the
   benchmark's spans, read by the other per-layer metrics;
4. the program's state freed, then the plain float32 reference
   (``benchmark/reference``) judges the captured units: each number compared
   is printed beside its limit, last on standard error and last in the
   result line (``checks``);
5. the result line, last on standard output.

Exits 2 without a result when CUDA or the cell's cards are missing, and 3
when the process has loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "t2v")


def cache_env(root: str) -> None:
    """Every kernel cache at a fixed path inside the checkout (the port
    builds its own into ``t2v_torch/_build/``), and no library loading JAX."""
    cache = os.path.join(root, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


class Run:
    """What a run measured, handed to the metric readers."""

    def __init__(self, cell, runner, peaks):
        self.cell, self.runner, self.peaks = cell, runner, peaks
        self.cfg, self.traffic = cell.config, cell.traffic
        self.setup_s = 0.0
        self.window_s = 0.0
        self.units = 0
        self.peak_bytes = 0
        self.unit_ends: list[float] = []  # seconds from the window's start to each unit's end
        self.unit_cpu: list[float] = []  # the process's CPU seconds in each unit
        self.unit_steal: list[float] = []  # the host's steal seconds (all cores) in each unit
        self.gc_runs = 0  # the collector's runs inside the window
        self.busy = None  # (busy s, window s) of the device-only trace
        self.trace = None
        self.notes = {}


def steal_s() -> float:
    """Seconds the hypervisor gave this machine's cores to others, summed
    over the cores (``/proc/stat``); 0 where the file is missing."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return 0.0


def captured_units(cell, seed: int) -> list[int]:
    from benchmark.prompts import request_rng

    chk = cell.check["check"]
    if not chk["units"]:
        return []
    rng = request_rng(seed, 0, stream=3)
    return sorted(int(i) for i in rng.choice(chk["within"], size=chk["units"], replace=False))


def run_cell(cell, seed: int, seconds: float, trace: bool, device, peaks=None) -> tuple[dict, Run]:
    """Set up, measure, trace and judge one cell; returns (result, run)."""
    import importlib

    import torch

    from benchmark import program, spec

    loop = cell.traffic["loop"]
    loops = importlib.import_module(f"benchmark.loops.{loop}")
    correct = importlib.import_module(f"benchmark.correct.{loop}")
    on_card = device.type == "cuda"
    runner = loops.Loop(cell.config, cell.traffic, seed, device, peaks)
    run = Run(cell, runner, peaks)
    runner.setup()
    if on_card:
        torch.cuda.synchronize()
    run.setup_s = time.perf_counter() - T0

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    runner.reset()
    runner.timer.on = on_card
    wanted = captured_units(cell, seed)
    captures = []
    gc_before = sum(g["collections"] for g in gc.get_stats())
    t0 = time.perf_counter()
    i = 0
    while True:
        if i in wanted:
            runner.capture = runner.new_capture()
        cpu, steal = time.process_time(), steal_s()
        runner.unit(i)
        run.unit_ends.append(time.perf_counter() - t0)
        run.unit_cpu.append(time.process_time() - cpu)
        run.unit_steal.append(steal_s() - steal)
        if runner.capture is not None:
            captures.append(runner.capture)
            runner.capture = None
        i += 1
        if time.perf_counter() - t0 >= seconds and i > max(wanted, default=-1):
            break
    if on_card:
        torch.cuda.synchronize()
    run.window_s = time.perf_counter() - t0
    run.units = i
    run.gc_runs = sum(g["collections"] for g in gc.get_stats()) - gc_before
    runner.counting = runner.timer.on = False
    if on_card:
        run.peak_bytes = torch.cuda.max_memory_allocated()

    if trace:
        from benchmark import trace as tracing

        n = cell.traffic["trace_units"]

        def units(first):
            for k in range(n):
                runner.unit(first + k)

        run.busy = tracing.busy(lambda: units(i))
        runner.annot.on = True
        run.trace = tracing.record(lambda: units(i + n))
        runner.annot.on = False

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    runner.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = correct.check(cell.config, cell.traffic, runner.setup_captures + captures, seed,
                            device, program.DTYPES[cell.config["dtype"]], cell.check["check"])
    limits = cell.check["limits"]
    run.notes = numbers.pop("notes", {})
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(v["value"] <= v["limit"] for v in checks.values())
    result = {"correct": bool(ok), "attempted": run.units, "failed": 0, "metrics": metrics}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(run.peak_bytes)}
    if run.trace is not None:
        dev.update(busy_s=run.busy[0], window_s=run.busy[1])
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["device"] = dev
    result["checks"] = checks
    return result, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ns = ap.parse_args(argv)
    cache_env(ROOT)

    from benchmark import spec

    cell = spec.cell(ns.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {ns.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    peaks = spec.load_json(os.path.join(spec.HERE, "work", "peaks.json")).get(
        torch.cuda.get_device_name())
    card = power_limit()
    result, run = run_cell(cell, ns.seed, ns.seconds, bool(ns.trace), device, peaks)
    if card:
        result["device"]["power"] = card
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {', '.join(found)}; the port must not",
              file=sys.stderr)
        return 3
    print(f"benchmark: {ns.workload} seed {ns.seed}: {run.units} units in {run.window_s:.3f} s, "
          f"set-up {run.setup_s:.3f} s, card {card}, {torch.get_num_threads()} torch threads, "
          f"{len(os.sched_getaffinity(0))} cores", file=sys.stderr)
    ends = [0.0] + run.unit_ends
    print("benchmark: unit seconds " + " ".join(f"{b - a:.3f}" for a, b in zip(ends, ends[1:])),
          file=sys.stderr)
    print("benchmark: unit cpu seconds " + " ".join(f"{c:.3f}" for c in run.unit_cpu),
          file=sys.stderr)
    print("benchmark: unit steal seconds " + " ".join(f"{c:.2f}" for c in run.unit_steal)
          + f"; {run.gc_runs} collector runs in the window", file=sys.stderr)
    if run.busy is not None:
        print(f"benchmark: traced {run.busy[1]:.3f} s, device busy {run.busy[0]:.3f} s; "
              f"with spans {run.trace.window_s:.3f} s, busy {run.trace.busy_s:.3f} s",
              file=sys.stderr)
    for k, v in run.notes.items():
        print(f"note {k}: {v:.6g} (not compared)", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']:.6g} (limit {v['limit']:.6g})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
