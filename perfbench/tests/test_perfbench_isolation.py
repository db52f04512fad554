"""No module of the benchmark imports ``jax`` or the JAX package ``repro``
(whole top-level names: ``repro_torch`` begins with ``repro``), the
reference imports nothing of ``repro_torch``, and a run loads neither."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set:
    """Top-level names of every absolute import in ``path``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _modules(sub=""):
    return sorted((HERE / sub).rglob("*.py"))


def test_the_scan_sees_every_module():
    names = {p.relative_to(HERE).as_posix() for p in _modules()}
    assert {"run.py", "check.py", "counts.py", "trace.py", "traffic.py",
            "control.py", "reference/bloomrf.py", "reference/truth.py",
            "metrics/kernels_roofline.py"} <= names


@pytest.mark.parametrize("path", _modules(), ids=lambda p: p.name)
def test_no_module_imports_jax_or_repro(path):
    assert not _imports(path) & FORBIDDEN


def test_the_whole_name_is_compared():
    assert "repro_torch" not in FORBIDDEN
    assert _imports(HERE / "run.py") >= {"torch"}


@pytest.mark.parametrize("path", _modules("reference"), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert _imports(path) <= {"__future__", "dataclasses", "math", "numpy",
                              "torch"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.level == 1       # only within reference/


def test_a_run_loads_neither(tmp_path):
    """A small cell run end to end on the CPU, in a process of its own (the
    test session itself may hold the JAX package): then the modules it
    loaded."""
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from perfbench import run
cell = run.load_cell("fig11-u32-1m.ranges")
cell.config["spec"].update(n=5000, backend="resident")
cell.traffic.update(batch=1024, pool=2)
res, out, _ = run.execute(cell, 2**31 + 5, 0.2, False, device="cpu")
print(json.dumps([res["correct"], run._loaded_forbidden(),
                  "repro_torch" in sys.modules]))
"""
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    correct, found, port = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and found == [] and port
