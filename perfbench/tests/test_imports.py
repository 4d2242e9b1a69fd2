"""What the benchmark runs loads neither JAX nor the JAX package, by whole
top-level names; the reference loads nothing of the program; a run
without a card fails and prints no result."""

import ast
import json
import os
import subprocess
import sys

import pytest

from perfbench import harness

ROOT = harness.BENCH_DIR.parent


def imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


def sources(*parts):
    base = harness.BENCH_DIR.joinpath(*parts)
    return [p for p in base.rglob("*.py") if "tests" not in p.parts]


def test_forbidden_names_are_compared_whole(monkeypatch):
    import types
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "rangeldm_tpu_torch.not_a_module",
                        types.ModuleType("m"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "rangeldm_tpu.models",
                        types.ModuleType("m"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("m"))
    assert harness.forbidden_modules() == ["jax", "rangeldm_tpu"]


@pytest.mark.parametrize("path", sources(), ids=lambda p: p.name)
def test_no_source_imports_jax(path):
    assert not set(imported_tops(path)) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sources("reference"), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "rangeldm_tpu_torch" not in set(imported_tops(path))


WALK = """
import json, sys, tempfile
from pathlib import Path
sys.path.insert(0, {root!r})
from perfbench import harness, calibrate
from perfbench.tests import tiny
bench = tiny.make_copy(Path(tempfile.mkdtemp()))
for cell, *_ in tiny.CELLS:
    harness.run(cell, 1, 0.1, cell.endswith("dpmpp"), device="cpu",
                root=bench)
for kind in ("sampling", "train"):
    harness.load_module(bench / "traffic" / (kind + ".py"), "k_" + kind)
for p in (bench / "metrics").glob("*.py"):
    harness.load_module(p, "m_" + p.stem.replace(".", "_"))
print(json.dumps({{"forbidden": harness.forbidden_modules(),
                  "program": "rangeldm_tpu_torch" in sys.modules}}))
"""


def test_what_a_run_reaches_loads_no_jax():
    """Every module a run of each kind of cell, each traffic kind and each
    metric reader reaches, in a fresh process."""
    env = dict(os.environ, OMP_NUM_THREADS="4")
    out = subprocess.run([sys.executable, "-c", WALK.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600,
                         env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"forbidden": [], "program": True}


REFERENCE_ONLY = """
import json, sys
sys.path.insert(0, {root!r})
import perfbench.reference.train, perfbench.reference.precision
import perfbench.work, perfbench.weights
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0].startswith("rangeldm"))))
"""


def test_reference_and_work_load_nothing_of_the_program():
    out = subprocess.run(
        [sys.executable, "-c", REFERENCE_ONLY.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "ldm_sample_ddim50_b32", "--seed", "3", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        env=env, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
