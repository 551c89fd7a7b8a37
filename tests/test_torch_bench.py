"""The port's bench (`bench_torch.py`) and the functions of its
every-config table (`tools/bench_all_torch.py`), on the CPU at tiny size.

* `bench_torch.main(device="cpu")` with BENCH_REPLICAS=2, BENCH_ROUNDS=1
  prints one JSON line with bench.py's keys: value > 0, vs_baseline =
  value / (100 * 1000) to its four decimals, the BP health of the rotamer
  cache, no `kernel_plain_rel_err` (no kernels on the CPU), device "cpu";
* `main(device="cuda")` raises when no card is present (decided here by
  patching `torch.cuda.is_available`, so the case runs everywhere);
* the gate's function: zero error when both sides take the plain
  versions (the CPU's case);
* `md_steps_per_sec` and `rex_steps_per_sec` (4 replicas, 2 rounds, an
  exchange every round; the acceptance equals successes over attempts of
  the swap stats, bench_all.py:96-99) on config 1's backbone-only
  trp-cage, `chi1_latency` and `training_throughput` (2 replicas, K = 1)
  on trp-cage at tiny depth: finite positive numbers.  (The Hamiltonian
  exchange row runs on the card, in chip_smoke.py's phase 14.)
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401 (autouse)
from upside_md_torch import bench_systems
from upside_md_torch.bench_systems import TRP_CAGE
from upside_md_torch.entry import full_system
from upside_md_torch.md import replica

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"metric", "value", "unit", "vs_baseline", "bp_sweeps_mean",
        "bp_n_bad_solve", "device"}


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench():
    sys.path.insert(0, ROOT)
    return _module("bench_torch", os.path.join(ROOT, "bench_torch.py"))


@pytest.fixture(scope="module")
def bench_all():
    return _module("bench_all_torch",
                   os.path.join(ROOT, "tools", "bench_all_torch.py"))


@pytest.fixture(scope="module")
def trp():
    return full_system(TRP_CAGE, "cpu")


@pytest.fixture(scope="module")
def backbone():
    return bench_systems.build_backbone_system(device="cpu")


def test_bench_prints_one_line_with_bench_keys(bench, monkeypatch, capsys):
    monkeypatch.setenv("BENCH_REPLICAS", "2")
    monkeypatch.setenv("BENCH_ROUNDS", "1")
    monkeypatch.setenv("BENCH_SEED", "5")
    record = bench.main(device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == record
    assert set(line) == KEYS
    assert "kernel_plain_rel_err" not in line
    assert line["device"] == "cpu"
    assert line["unit"] == "steps/s"
    assert line["metric"].endswith(
        "synthetic libraries (ubiquitin_full_synth), 2 replicas")
    assert np.isfinite(line["value"]) and line["value"] > 0
    assert abs(line["vs_baseline"] - line["value"] / 1e5) <= 5e-5 + 1e-12
    assert line["bp_sweeps_mean"] >= 1
    assert 0 <= line["bp_n_bad_solve"] <= 2


def test_bench_refuses_to_run_without_a_card(bench, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(device="cuda")


def test_gate_is_zero_between_two_plain_runs(bench, trp):
    system, _, pos, _ = trp
    worst, err_e, err_g = bench.kernel_plain_rel_err(
        system, pos[None].expand(2, -1, -1))
    assert worst == err_e == err_g == 0.0


def test_md_and_temperature_exchange(bench_all, backbone, monkeypatch):
    system, params, pos, _ = backbone
    sps = bench_all.md_steps_per_sec(system, params, pos, 2, n_rounds=1)
    assert np.isfinite(sps) and sps > 0
    seen = []
    attempt = replica.ReplicaExchange.attempt_swaps

    def spy(self, *a, **kw):
        out = attempt(self, *a, **kw)
        seen.append(out[2])
        return out
    monkeypatch.setattr(replica.ReplicaExchange, "attempt_swaps", spy)
    sps, acc = bench_all.rex_steps_per_sec(system, params, pos, 4, 2, 1,
                                           seed=3)
    assert np.isfinite(sps) and sps > 0
    # warm-up plus three timed calls, two exchange rounds each
    assert len(seen) == 8
    stats = np.concatenate([s.numpy() for s in seen[-1]])
    # 8 exchange rounds over the sets (0-1, 2-3) and (1-2): 3 pairs each
    assert stats[:, 1].sum() == 8 * 3
    assert acc == stats[:, 0].sum() / stats[:, 1].sum()
    assert 0.0 <= acc <= 1.0


def test_chi1_and_training(bench_all):
    t_dev, t_total = bench_all.chi1_latency("cpu", TRP_CAGE, K=2,
                                            n_total=1)
    assert np.isfinite([t_dev, t_total]).all() and min(t_dev, t_total) > 0
    t_dev, t_total = bench_all.training_throughput(2, 1, "cpu", TRP_CAGE)
    assert np.isfinite([t_dev, t_total]).all() and min(t_dev, t_total) > 0
