"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program: checked on every import statement
of the benchmark's sources and on the modules a process holds after
importing them, by whole top-level name (the program's package name begins
with the JAX package's)."""

import ast
import os
import subprocess
import sys

import pytest

from mdbench import harness
from mdbench.tests.tiny import ROOT

JAX = {"jax", "jaxlib", "flax", "upside_md_tpu"}
SOURCES = sorted(
    os.path.join(d, f) for d, _, fs in os.walk(harness.BENCH)
    for f in fs if f.endswith(".py") and os.sep + "tests" not in d)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, ROOT) for p in SOURCES])
def test_sources_import_no_jax(path):
    names = top_level_imports(path)
    assert not names & JAX
    if os.sep + "reference" + os.sep in path:
        assert "upside_md_torch" not in names
        assert names <= {"__future__", "json", "math", "numpy", "torch"}


def loaded_after(code):
    r = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split"
         "('.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert r.returncode == 0, r.stderr
    return set(eval(r.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    loaded = loaded_after(
        "import mdbench.reference.forcefield, mdbench.reference.md, "
        "mdbench.reference.train, mdbench.reference.bp")
    assert not loaded & (JAX | {"upside_md_torch"})


def test_a_run_loads_no_jax():
    """Every mode and metric, and the program they drive."""
    loaded = loaded_after(
        "from mdbench import harness, roofline, trace, compare, inputs\n"
        "import os\n"
        "for k in ('modes', 'metrics'):\n"
        "    for f in os.listdir(os.path.join(harness.BENCH, k)):\n"
        "        if f.endswith('.py') and not f.startswith('_'):\n"
        "            harness.load_module(k, f[:-3])\n"
        "import upside_md_torch.training, upside_md_torch.md.sim\n")
    assert "upside_md_torch" in loaded
    assert not loaded & JAX


def test_forbidden_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "upside_md_torch_like", object())
    assert "upside_md_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "upside_md_tpu.nodes", object())
    assert "upside_md_tpu" in harness.forbidden_modules()
