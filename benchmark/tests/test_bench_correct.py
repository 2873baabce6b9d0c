"""The check that decides ``correct``, driven through the harness at CPU size.

A sound run of each cell comes out correct. The control (the reference with
float8 operands in the program's place) and each fault a cell can have,
planted underneath the harness, come out not correct. Request cells: a
sampler step that returns its state unchanged; half of the UNet batch left
out and the mean of the rest put in its place; a frame altered where the
decode produces it. The training cell: a step that leaves the adapter
unchanged; half of the batch left out of the loss, its mean taken over the
rest; one leaf's gradient altered where it is produced. (The exchange
between chips is a fault of four-chip cells; every cell here runs on one.)
"""

import pytest
import torch

from benchmark import faults
from benchmark import run as bench_run
from benchmark.correct import request as correct
from benchmark.loops.request import videos
from benchmark.reference.ops import Ops, strict_fp32
from benchmark.reference.text import Tokenizer
from benchmark.tests.conftest import tiny_cell
from benchmark import program

CELLS = ["ms24f-request", "vc16f-request", "ms24f-batch4"]
TRAIN = "ms-lora-train-b4"
SEED = 2**31 + 12345  # a run's seed may need more than 32 signed bits


def _run(cell):
    res, _ = bench_run.run_cell(cell, SEED, 0.5, False, torch.device("cpu"))
    return res


@pytest.mark.parametrize("name", CELLS + [TRAIN])
def test_sound_run_is_correct(name):
    res = _run(tiny_cell(name))
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = tiny_cell(name)
    cfg, tr, dev = cell.config, cell.traffic, torch.device("cpu")
    tok = Tokenizer(cfg["tokenizer"]["merge_words"])
    units = [videos(tr, tok, SEED, i) for i in bench_run.captured_units(cell, SEED)]
    sd = program.reference_weights(cfg, SEED, dev, torch.float32)
    caps = correct.control(cfg, tr, units, SEED, dev, torch.float32, sd)
    with strict_fp32():
        nums = correct.judge(correct.Reference(cfg, SEED, dev, torch.float32, Ops(), sd), tr,
                             caps, SEED, cell.check["check"]["calls"])
    nums.pop("notes")
    limits = cell.check["limits"]
    assert any(v > limits[k] for k, v in nums.items()), nums


@pytest.mark.parametrize("fault", sorted(faults.REQUEST))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    faults.REQUEST[fault](monkeypatch)
    res = _run(tiny_cell(name))
    assert not res["correct"], res["checks"]


def test_training_control_is_not_correct():
    from benchmark.correct import lora_train

    cell = tiny_cell(TRAIN)
    cfg, tr, dev = cell.config, cell.traffic, torch.device("cpu")
    sd = program.reference_weights(cfg, SEED, dev, torch.float32)
    cap = lora_train.control(cfg, tr, SEED, dev, torch.float32, sd)
    with strict_fp32():
        nums = lora_train.judge(cfg, tr, cap, SEED, dev, torch.float32, Ops(), sd)
    nums.pop("notes")
    assert any(v > cell.check["limits"][k] for k, v in nums.items()), nums


@pytest.mark.parametrize("fault", sorted(faults.TRAINING))
def test_training_fault_is_not_correct(fault, monkeypatch):
    faults.TRAINING[fault](monkeypatch)
    res = _run(tiny_cell(TRAIN))
    assert not res["correct"], res["checks"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS + [TRAIN])
def test_control_fails_at_cell_size(name, card):
    """On the card: the control at the cell's own size fails a limit."""
    from benchmark import spec
    from benchmark.control import control_readings

    cell = spec.cell(name)
    nums = control_readings(cell, SEED, card)
    assert any(v > cell.check["limits"][k] for k, v in nums.items()), nums


def test_training_look_reads_every_side():
    """The look at where training parts from the reference runs at CPU size:
    the program in float32 there is the reference's arithmetic, so its gaps
    are round-off."""
    from benchmark.look_lora import look

    cell = tiny_cell(TRAIN)
    cell.config["dtype"] = "float32"
    out = look(cell, SEED, torch.device("cpu"))
    assert len(out["t"]) == cell.traffic["checked_steps"]
    for side in ("ref_bf16", "program", "program_fp32"):
        assert len(out[side]["loss"]) == cell.traffic["checked_steps"]
        assert 0 <= out[side]["all_elements"]["parted"] <= 1
    assert max(out["program_fp32"]["loss"]) < 1e-4
