"""Every cell, configuration and metric of BENCHMARK.json has its file,
and every file names only things that exist."""

import json
import os

import numpy as np
import pytest

from mdbench.tests.tiny import ROOT
from mdbench import harness

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_names_its_files():
    assert BENCH["paths"] == ["mdbench"]
    assert BENCH["command"] == ["python3", "mdbench/run.py"]
    for c in BENCH["configs"]:
        assert c["file"] == f"mdbench/configs/{c['name']}.json"
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["reduced"] == harness.load_json("configs", c["name"])[
            "reduced"]
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    assert len(names) == len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert os.path.isfile(os.path.join(harness.BENCH, "metrics",
                                           m["name"] + ".py"))
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    wl = harness.load_workload(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert entry["config"] == wl["config"]["name"]
    assert entry["chips"] == wl["chips"] == 1
    assert entry["why"] == wl["why"]
    assert os.path.isfile(harness.bundle_path(wl["config"]))
    harness.load_module("modes", wl["mode"]).Run
    listed = {m["name"] for m in BENCH["per_layer"]
              if cell in m["workloads"]}
    assert set(wl["per_layer"]) == listed
    for name in wl["per_layer"]:
        reader = harness.load_module("metrics", name)
        unit = next(m["unit"] for m in BENCH["per_layer"]
                    if m["name"] == name)
        assert reader.UNIT == unit
    for m in BENCH["end_to_end"]:
        assert ("workloads" not in m) or (cell in m["workloads"]) or \
            m["name"] != "setup_s"
    assert set(wl["limits"]) and all(v > 0 for v in wl["limits"].values())
    if "frames" in wl:
        pool = np.load(wl["frames_file"], mmap_mode="r")
        atoms = harness.load_json("configs", wl["config"]["name"])["atoms"]
        assert pool.shape[1:] == (atoms, 3) and len(pool) >= wl["ensemble"]
        assert pool.dtype == np.float32 and np.isfinite(pool).all()


def test_missing_names_are_refused():
    with pytest.raises(FileNotFoundError):
        harness.load_workload("no_such_cell")
    with pytest.raises(FileNotFoundError):
        harness.load_module("metrics", "no_such_metric")
