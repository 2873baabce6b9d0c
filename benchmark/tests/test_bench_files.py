"""BENCHMARK.json and the files it names: every name resolves to a file that
parses, names and units keep to the allowed characters, and the limits of
the contract hold."""

import importlib
import json
import os

import pytest

from benchmark import spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells has to fit in 43,200 s
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in METRICS]
             + [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    for n in names:
        assert spec.NAME.match(n), n
    for m in METRICS:
        assert spec.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({x["name"] for x in group}) == len(group)
    lines = ([c["source"] for c in BENCH["configs"]] + [c["why"] for c in BENCH["configs"]]
             + [w["why"] for w in BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]])
    for text in lines:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text


@pytest.mark.parametrize("name", CELLS)
def test_cell_files(name):
    cell = spec.cell(name)
    assert cell.chips in (1, 4)
    for mod in ("loops", "correct"):  # the loop that runs the traffic and its comparison
        assert os.path.exists(os.path.join(spec.HERE, mod, cell.traffic["loop"] + ".py"))
    assert os.path.exists(os.path.join(spec.HERE, "families", cell.config["family"] + ".py"))
    assert callable(importlib.import_module(f"benchmark.correct.{cell.traffic['loop']}").check)
    loop = importlib.import_module(f"benchmark.loops.{cell.traffic['loop']}")
    assert set(cell.traffic) <= loop.KEYS, sorted(set(cell.traffic) - loop.KEYS)
    assert set(cell.check) == {"check", "limits"}
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer


@pytest.mark.parametrize("key", ["clients", "arrivals"])
@pytest.mark.parametrize("name", CELLS)
def test_loop_refuses_a_key_it_does_not_read(key, name):
    cell = spec.cell(name)
    loop = importlib.import_module(f"benchmark.loops.{cell.traffic['loop']}")
    with pytest.raises(ValueError, match=key):
        loop.Loop(cell.config, dict(cell.traffic, **{key: 4}), 1, None, None)


@pytest.mark.parametrize("name", CELLS)
def test_cells_over_several_cards_split_over_them(name):
    """A cell whose traffic splits its frames (the request loop's
    ``sp_shards``) runs one rank a shard, so one a card."""
    cell = spec.cell(name)
    assert cell.traffic.get("sp_shards", cell.chips) == cell.chips


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_readers(metric):
    assert callable(spec.reader(metric))


def test_metric_entries():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    assert conf["file"].startswith("benchmark/")
    cfg = spec.load_json(os.path.join(spec.ROOT, conf["file"]))
    assert os.path.exists(os.path.join(spec.HERE, "families", cfg["family"] + ".py"))
    assert cfg["source"] == conf["source"]
    assert cfg["dtype"] == "bfloat16"
    # a reduced key is one of the model's sections' keys, as the family names them
    sections = spec.family(cfg).SECTIONS
    assert set(conf["reduced"]) <= {k for s in sections for k in cfg[s]}
