"""The readers of the program's recorder (`upside_md_torch/tracing.py`),
each on a window of a tiny cell on the CPU under a CPU `torch.profiler`,
as a traced run's window opens it: each reads a positive number of
milliseconds, raises when the recorder counted other evaluations or steps
than the window, and reads nothing from a program without the recorder.
No cell lists them yet: a cell reports a reader once its workload file's
`per_layer` names it and `BENCHMARK.json` declares the metric."""

import sys
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mdbench import harness
from mdbench.tests.tiny import CPU, MD_CELLS, TRAIN_CELLS, tiny

READERS = {
    "ubq_full.ens4096": ("plain_nodes_ms_per_eval", "bp_solve_ms_per_eval",
                         "host_enqueue_ms_per_eval"),
    "t4l_full.ens512": ("plain_nodes_ms_per_eval", "bp_solve_ms_per_eval",
                        "host_enqueue_ms_per_eval", "host_sync_ms_per_eval"),
    "ubq_full.train_cd1024": ("table_cotangent_ms_per_step",
                              "host_sync_ms_per_step"),
}


def traced_window(cell):
    """The number of evaluations (MD) or steps (training) of a profiled
    window of the tiny cell."""
    wl = tiny(cell)
    run = harness.load_module("modes", wl["mode"]).Run(wl, CPU, 2 ** 40 + 9)
    if cell in MD_CELLS:
        sim, state, noise = run._program()
        state = sim.advance(state, 1, noise=noise)
        with profile(activities=[ProfilerActivity.CPU]):
            sim.advance(state, wl["chunk_rounds"], noise=noise)
        return 3 * wl["chunk_rounds"]
    training, loss, trainable, frozen, _, _ = run._program()
    with profile(activities=[ProfilerActivity.CPU]):
        training.fit(loss, trainable, frozen, n_steps=2,
                     learning_rate=wl["learning_rate"])
    return 2


@pytest.mark.parametrize("cell", MD_CELLS + TRAIN_CELLS)
def test_readers_of_the_recorder(cell, monkeypatch):
    torch.set_num_threads(2)
    n = traced_window(cell)
    for name in READERS[cell]:
        reader = harness.load_module("metrics", name)
        value = reader.read(types.SimpleNamespace(evals=n))
        assert value is not None and value > 0, name
        with pytest.raises(RuntimeError):
            reader.read(types.SimpleNamespace(evals=n + 1))
    # a program without the recorder: the parent commit's
    import upside_md_torch
    monkeypatch.delattr(upside_md_torch, "tracing")
    monkeypatch.setitem(sys.modules, "upside_md_torch.tracing", None)
    for name in READERS[cell]:
        reader = harness.load_module("metrics", name)
        assert reader.read(types.SimpleNamespace(evals=n)) is None
