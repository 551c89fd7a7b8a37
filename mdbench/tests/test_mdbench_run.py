"""One run of `mdbench/run.py` prints the contract's last line; without a
CUDA device, or without the program beside it, it prints no result and
exits non-zero."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from mdbench.tests.tiny import ROOT

TINY_RUN = """
import sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from mdbench import run
from mdbench.tests.tiny import tiny
sys.exit(run.main(['--workload', {cell!r}, '--seed', '3000000001',
                   '--seconds', '0.5', '--trace', '0'],
                  device=torch.device('cpu'), workload=tiny({cell!r})))
"""


def python(code_or_args, cwd=ROOT, timeout=600):
    args = ["-c", code_or_args] if isinstance(code_or_args, str) \
        else code_or_args
    return subprocess.run([sys.executable] + args, cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("cell", ["ubq_full.ens4096", "ubq_full.train_cd1024"])
def test_last_line_has_the_contract_shape(cell):
    r = python(TINY_RUN.format(root=ROOT, cell=cell))
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    e2e = "steps_per_s" if "ens" in cell else "train_step_ms"
    assert set(line["metrics"]) == {e2e, "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    tail = r.stderr.strip().splitlines()[-len(line["checks"]):]
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"]
        assert any(t.startswith(f"check {name} = ") for t in tail)


def test_no_result_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = python(["mdbench/run.py", "--workload", "ubq_full.ens4096",
                "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and mdbench/."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "mdbench"), tmp_path / "mdbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    code = TINY_RUN.format(root=str(tmp_path), cell="ubq_full.train_cd1024")
    r = python(code, cwd=tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.requires_cuda
def test_train_cell_on_the_card(cuda):
    r = python(["mdbench/run.py", "--workload", "ubq_full.train_cd1024",
                "--seed", "77", "--seconds", "2", "--trace", "0"])
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
