"""The benchmark's files, found by the names in ``BENCHMARK.json``.

* ``benchmark/configs/<config>.json``: a model configuration as it runs,
  whose ``family`` names ``benchmark/families/<family>.py``: the port's
  pipeline of that family, its parameter lists, its plain reference and its
  operation counts;
* ``benchmark/traffic/<traffic>.json``: a traffic mix, run by the loop its
  ``loop`` names (``benchmark/loops/<loop>.py``) and judged by the comparison of
  the same name (``benchmark/correct/<loop>.py``);
* ``benchmark/workloads/<cell>.json``: the cell's correctness check (which
  units and calls the reference judges) and the limit of each number it
  compares;
* ``benchmark/metrics/<metric>.py``, else ``benchmark/metrics/<prefix>.py``
  for a metric ``<prefix>.<suffix>``: the reader of a metric.
"""

from __future__ import annotations

import functools
import importlib
import importlib.util
import json
import os
import re
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name, chips=entry["chips"], config=load_json(os.path.join(ROOT, conf["file"])),
        traffic=load_json(os.path.join(HERE, "traffic", entry["traffic"] + ".json")),
        check=load_json(os.path.join(HERE, "workloads", name + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def only_keys(traffic: dict, keys: frozenset, loop: str) -> None:
    """Refuse a traffic mix that sets what its loop does not read (a later
    mix asking for more clients or open-loop arrivals needs a loop of its
    own, not a key that this one would pass over)."""
    unknown = sorted(set(traffic) - keys)
    if unknown:
        raise ValueError(f"the {loop} loop reads no {', '.join(unknown)}")


def loop(traffic: dict) -> tuple:
    """(the module of the traffic's loop, the module of its comparison):
    ``benchmark/loops/<loop>.py`` and ``benchmark/correct/<loop>.py``, or,
    where ``loop`` is a dotted module path, that one module for both (the
    stub loop of the harness's tests)."""
    name = traffic["loop"]
    if "." in name:
        mod = importlib.import_module(name)
        return mod, mod
    return (importlib.import_module(f"benchmark.loops.{name}"),
            importlib.import_module(f"benchmark.correct.{name}"))


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _family(name: str):
    path = os.path.join(HERE, "families", name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no family {name!r}: benchmark/families/{name}.py is missing")
    return load_module(path, "benchmark_family_" + name.replace(".", "_").replace("-", "_"))


def family(cfg: dict):
    """The module of the configuration's model family, loaded once."""
    return _family(cfg["family"])


def reader(metric: str):
    """The ``read(run)`` function of a metric."""
    for stem in (metric, metric.split(".")[0]):
        path = os.path.join(HERE, "metrics", stem + ".py")
        if os.path.exists(path):
            return load_module(path, "benchmark_metric_" + stem.replace(".", "_")).read
    raise FileNotFoundError(f"no reader for metric {metric!r} under benchmark/metrics")
