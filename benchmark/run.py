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

A cell of ``chips`` above 1 runs one rank a card (``benchmark/ranks.py``):
this process is rank 0 on ``cuda:0`` and does all of the above; the others
run the same set-up and units in lockstep, and hand rank 0 their memory
peaks (the result's is the largest) and their share of the captures.

Exits 2 without a result when CUDA or the cell's cards are missing, 3 when
any rank's process has loaded JAX or the JAX package, and 1 when a rank
fails.
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


def forbidden_mask() -> int:
    """``forbidden_modules`` as bits of ``FORBIDDEN``, to gather from each rank."""
    found = forbidden_modules()
    return sum(1 << i for i, name in enumerate(FORBIDDEN) if name in found)


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
        self.peaks_by_rank: list[int] = []  # each rank's memory peak over the window
        self.forbidden_by_rank: list[int] = []  # each rank's ``forbidden_mask`` at its end
        self.on_card = False
        self.busy = None  # (busy s, window s) of the device-only trace
        self.trace = None
        self.notes = {}
        self.check_s = 0.0  # seconds the reference took to judge the captures


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


def memory_peak(device) -> int:
    """The most memory this process has held on ``device`` since the last
    reset: the CUDA allocator's peak on a card, the process's resident peak
    on the CPU (where the harness runs only in tests)."""
    if device.type == "cuda":
        import torch

        return torch.cuda.max_memory_allocated(device)
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def run_cell(cell, seed: int, seconds: float, trace: bool, device, peaks=None,
             ranks=None) -> tuple[dict | None, Run]:
    """Set up, measure, trace and judge one cell as one rank of ``ranks`` (a
    group of one by default); returns (result, run) on rank 0 and (None,
    run) on the others."""
    import torch

    from benchmark import program, spec
    from benchmark.ranks import ONE

    ranks = ranks or ONE
    loops, correct = spec.loop(cell.traffic)
    on_card = device.type == "cuda"
    runner = loops.Loop(cell.config, cell.traffic, seed, device, peaks)
    run = Run(cell, runner, peaks)
    run.on_card = on_card
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
        if ranks.agree(time.perf_counter() - t0 >= seconds and i > max(wanted, default=-1)):
            break
    if on_card:
        torch.cuda.synchronize()
    run.window_s = time.perf_counter() - t0
    run.units = i
    run.gc_runs = sum(g["collections"] for g in gc.get_stats()) - gc_before
    runner.counting = runner.timer.on = False
    run.peaks_by_rank = ranks.each(memory_peak(device))
    run.peak_bytes = max(run.peaks_by_rank)

    if trace:
        from benchmark import trace as tracing

        n = cell.traffic["trace_units"]

        def units(first):
            for k in range(n):
                runner.unit(first + k)

        if ranks.primary:
            run.busy = tracing.busy(lambda: units(i))
            runner.annot.on = True
            run.trace = tracing.record(lambda: units(i + n))
            runner.annot.on = False
        else:  # the same units, untraced: they are collective
            units(i)
            units(i + n)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end) if ranks.primary else ():
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    captures = runner.gathered(runner.setup_captures + captures)
    runner.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    run.forbidden_by_rank = ranks.each(forbidden_mask())
    ranks.close()
    if not ranks.primary:
        return None, run
    t_check = time.perf_counter()
    numbers = correct.check(cell.config, cell.traffic, captures, seed,
                            device, program.DTYPES[cell.config["dtype"]], cell.check["check"])
    run.check_s = time.perf_counter() - t_check
    limits = cell.check["limits"]
    run.notes = numbers.pop("notes", {})
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(v["value"] <= v["limit"] for v in checks.values())
    result = {"correct": bool(ok), "attempted": run.units, "failed": 0, "metrics": metrics}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": ranks.world, "memory_peak_bytes": int(run.peak_bytes)}
    if run.trace is not None:
        dev.update(busy_s=run.busy[0], window_s=run.busy[1])
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["device"] = dev
    result["checks"] = checks
    return result, run


def launch(cell, seed: int, seconds: float, trace: bool, device_type: str = "cuda",
           fault: str | None = None) -> tuple[dict, Run]:
    """Run ``cell`` with this process as rank 0, on ``cuda:0`` (or the
    CPU), the other ranks started and stopped here; ``fault`` names a fault
    of ``benchmark/faults.py`` planted in every rank. Returns rank 0's
    (result, run)."""
    import torch

    from benchmark import faults, ranks as group, spec

    peaks = None
    if device_type == "cuda":
        peaks = spec.load_json(os.path.join(spec.HERE, "work", "peaks.json")).get(
            torch.cuda.get_device_name(0))
    if cell.chips == 1:
        device = torch.device(device_type, 0) if device_type == "cuda" else torch.device("cpu")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        with faults.planted(fault):
            return run_cell(cell, seed, seconds, trace, device, peaks)
    port = group.free_port()
    procs = group.start(cell, seed, seconds, trace, port, device_type, fault)
    watch = group.Watch(procs)
    try:
        ranks = group.join(0, cell.chips, port, device_type)
        with faults.planted(fault):
            return run_cell(cell, seed, seconds, trace, ranks.device, peaks, ranks=ranks)
    finally:
        watch.close()
        group.stop(procs)


def serve(cell, seed: int, seconds: float, trace: bool, device_type: str = "cuda") -> int:
    """Run ``cell`` (``launch``) and print rank 0's lines: what the run
    measured and each number compared, on standard error, then the result
    line, last on standard output. Returns the exit code."""
    import torch

    card = power_limit() if device_type == "cuda" else None
    result, run = launch(cell, seed, seconds, trace, device_type)
    if card:
        result["device"]["power"] = card
    masks = list(run.forbidden_by_rank) or [0]
    masks[0] |= forbidden_mask()  # rank 0 once more, after the reference
    loaded = {r: [name for i, name in enumerate(FORBIDDEN) if m >> i & 1]
              for r, m in enumerate(masks) if m}
    if loaded:
        for r, names in loaded.items():
            print(f"benchmark: rank {r} loaded {', '.join(names)}; the port must not",
                  file=sys.stderr)
        return 3
    print(f"benchmark: {cell.name} seed {seed}: {run.units} units in {run.window_s:.3f} s, "
          f"set-up {run.setup_s:.3f} s, card {card}, {torch.get_num_threads()} torch threads, "
          f"{len(os.sched_getaffinity(0))} cores", file=sys.stderr)
    ends = [0.0] + run.unit_ends
    print("benchmark: unit seconds " + " ".join(f"{b - a:.3f}" for a, b in zip(ends, ends[1:])),
          file=sys.stderr)
    print("benchmark: unit cpu seconds " + " ".join(f"{c:.3f}" for c in run.unit_cpu),
          file=sys.stderr)
    print("benchmark: unit steal seconds " + " ".join(f"{c:.2f}" for c in run.unit_steal)
          + f"; {run.gc_runs} collector runs in the window", file=sys.stderr)
    if len(run.peaks_by_rank) > 1:
        print("benchmark: memory peak by rank " + " ".join(str(b) for b in run.peaks_by_rank),
              file=sys.stderr)
    if run.busy is not None:
        print(f"benchmark: traced {run.busy[1]:.3f} s, device busy {run.busy[0]:.3f} s; "
              f"with spans {run.trace.window_s:.3f} s, busy {run.trace.busy_s:.3f} s; "
              f"{len(run.trace.unmatched)} device operations with no launch found "
              f"{sorted(set(run.trace.unmatched))[:3]}", file=sys.stderr)
    print(f"benchmark: the check took {run.check_s:.1f} s", file=sys.stderr)
    for k, v in run.notes.items():
        print(f"note {k}: {v:.6g} (not compared)", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']:.6g} (limit {v['limit']:.6g})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


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
    return serve(cell, ns.seed, ns.seconds, bool(ns.trace))


if __name__ == "__main__":
    sys.exit(main())
