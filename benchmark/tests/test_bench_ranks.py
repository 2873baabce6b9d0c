"""The ranks of a cell over several cards (``benchmark/ranks.py``), on the
CPU over gloo: the plumbing with a stub loop, then a ModelScope request
with its frames split over two ranks, sound and with each fault a cell over
several cards can have planted in every rank."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import faults, spec
from benchmark import run as bench_run
from benchmark.tests.conftest import tiny_cell
from benchmark.tests.stub_loop import PEAKS

SP_CELL = next(w["name"] for w in spec.benchmark()["workloads"] if w["chips"] > 1)
SEED = 2**31 + 4242


def _stub_run(**traffic) -> subprocess.CompletedProcess:
    """A two-rank run of the stub loop in a fresh process, on the CPU."""
    code = (
        "import sys\n"
        "from benchmark import run, spec\n"
        "cell = spec.Cell(name='stub', chips=2, config={'dtype': 'float32'},\n"
        f"                 traffic=dict(loop='benchmark.tests.stub_loop', trace_units=1, **{traffic!r}),\n"
        "                 check={'check': {'units': 0, 'within': 0, 'calls': 0},\n"
        "                        'limits': {'stub': 0.0}},\n"
        "                 end_to_end=[{'name': 'request_s', 'unit': 's'},\n"
        "                             {'name': 'setup_s', 'unit': 's'}], per_layer=[])\n"
        "if __name__ == '__main__':\n"
        "    sys.exit(run.serve(cell, 3, 0.5, False, 'cpu'))\n"
    )
    return subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, PYTHONPATH=spec.ROOT))


def test_rank_zero_alone_prints_and_the_peak_is_the_largest():
    """A two-rank run of a stub loop in a fresh process: one result line,
    last on standard output, only rank 0's lines there; its memory peak is
    the larger of the two ranks' (rank 1's)."""
    out = _stub_run()
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    result = json.loads(lines[-1])
    assert sum(line.startswith("{") for line in lines) == 1
    assert "stub rank 0 unit" in out.stdout and "stub rank 1" not in out.stdout
    assert "stub rank 1 unit" in out.stderr
    assert result["correct"] and result["device"]["count"] == 2
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    by_rank = next(line for line in out.stderr.splitlines() if "memory peak by rank" in line)
    peaks = [int(v) for v in by_rank.split("rank")[-1].split()]
    assert peaks == list(PEAKS)
    assert result["device"]["memory_peak_bytes"] == PEAKS[1]


@pytest.mark.parametrize("rank", [0, 1])
def test_a_rank_that_loads_jax_ends_the_run_without_a_result(rank):
    """A process of any rank holding ``flax`` (or ``jax``, ``jaxlib``, the
    JAX package) once its window is over: exit 3, no result line, the rank
    and the module named on standard error."""
    out = _stub_run(flax_on_rank=rank)
    assert out.returncode == 3, out.stderr[-3000:]
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    assert f"benchmark: rank {rank} loaded flax" in out.stderr


def test_agreement_of_a_group_of_one():
    from benchmark.ranks import ONE

    assert ONE.agree(True) and not ONE.agree(False)
    assert ONE.each(7) == [7] and ONE.primary


def test_frame_split_run_is_correct():
    cell = tiny_cell(SP_CELL)
    assert cell.chips == 2 and cell.traffic["sp_shards"] == 2
    res, run = bench_run.launch(cell, SEED, 0.5, False, "cpu")
    assert res["correct"], res["checks"]
    assert res["device"]["count"] == 2 and len(run.peaks_by_rank) == 2
    assert res["device"]["memory_peak_bytes"] == max(run.peaks_by_rank)
    # rank 0 decodes every video of the window, and decode_ms reads its time
    assert len(run.runner.decode_s) == run.units and min(run.runner.decode_s) > 0
    assert spec.reader("decode_ms.request")(run) > 0


@pytest.mark.parametrize("fault", sorted({**faults.REQUEST, **faults.EXCHANGE}))
def test_frame_split_fault_is_not_correct(fault):
    res, _ = bench_run.launch(tiny_cell(SP_CELL), SEED, 0.5, False, "cpu", fault=fault)
    assert not res["correct"], res["checks"]


def test_a_frame_split_needs_a_rank_a_shard():
    from benchmark.loops.request import Loop

    cell = tiny_cell(SP_CELL)
    with pytest.raises(ValueError, match="sp_shards 2 on 1 rank"):
        Loop(cell.config, cell.traffic, 1, None, None)
