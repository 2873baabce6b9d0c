"""Nothing under benchmark/ imports JAX or the JAX package, judged by the
whole top-level module name (the part before the first dot), so that
``t2v_torch`` passes and ``t2v`` does not: neither in its sources nor in
what a CPU dry run of a cell loads."""

import ast
import os
import subprocess
import sys

from benchmark import spec
from benchmark.run import FORBIDDEN


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_no_forbidden_import_in_sources():
    found = []
    for dirpath, _, files in os.walk(spec.HERE):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                found += [(path, m) for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not found


def test_whole_name_comparison():
    assert "t2v_torch".split(".")[0] not in FORBIDDEN
    assert "t2v.models".split(".")[0] in FORBIDDEN


def test_dry_run_loads_none():
    """A CPU run of every request cell at tiny size, in a fresh process,
    then the top-level names of every module it holds."""
    code = (
        "import sys, torch\n"
        "from benchmark.tests.conftest import tiny_cell\n"
        "from benchmark import run\n"
        "for name in ('ms24f-request', 'vc16f-request', 'ms24f-batch4'):\n"
        "    res, _ = run.run_cell(tiny_cell(name), 7, 0.1, False, torch.device('cpu'))\n"
        "    assert res['correct'], res\n"
        "print('LOADED', ','.join(run.forbidden_modules()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=600, env=dict(os.environ, PYTHONPATH=spec.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "LOADED", out.stdout
