"""The recorder of `upside_md_torch/tracing.py` on the CPU, on the trp-cage
bundle (the card's CUDA events are not exercised here):

* off, a span is one shared object and allocates nothing;
* nesting: parents, self times and the sums by pair of names add up, and
  the counters change with the window;
* a CPU `torch.profiler` opens a window and the first span after it
  stops closes it; the spans lie on the profiler's clock, and its events
  of them are the user annotations `is_user_annotation` names;
* one `System.deriv` gives every node a forward span and, where a
  cotangent reaches its output, a backward span;
* a `Simulation.advance` chunk is bitwise the same with spans on and off;
* `kernels.LAUNCHES` and `bp_pairs.HOST_SYNCS` are the recorder's
  counters, and every host sync is a span;
* the neighbour lists (thresholds lowered): each list's span, its nested
  build, its backward span and its count, no host sync added and forces
  bitwise the same with spans on; the dense paths open no list span;
* a training step's spans, and `write_chrome`'s file.
"""

import json
import os
import time
import tracemalloc
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_threads import one_thread  # noqa: F401 (autouse)
from upside_md_torch import DATA_DIR, tracing, training
from upside_md_torch.md.sim import Simulation
from upside_md_torch.ops import bp_pairs, kernels
from upside_md_torch.system import System

TRP = os.path.join(DATA_DIR, "trp_cage_full_synth.npz")


@pytest.fixture(scope="module")
def trp():
    return System.from_bundle(TRP, "cpu")


@pytest.fixture(autouse=True)
def recorder_off():
    tracing.disable()
    yield
    tracing.disable()


def window_of(fn):
    tracing.enable()
    try:
        fn()
    finally:
        tracing.disable()
    return tracing.last_window()


def test_off_allocates_and_records_nothing():
    before = tracing.last_window()
    assert tracing.span("a.b") is tracing.span("c.d") is tracing.NOOP
    assert tracing.backward_span("a.b.bwd") is None
    tracemalloc.start()
    try:
        snap0 = tracemalloc.take_snapshot()
        for i in range(1000):
            with tracing.span("a.b", i):
                pass
        snap1 = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    here = [tracemalloc.Filter(True, tracing.__file__)]
    grown = snap1.filter_traces(here).compare_to(
        snap0.filter_traces(here), "filename")
    assert sum(d.size_diff for d in grown) == 0
    assert tracing.last_window() is before


def test_nesting_self_times_and_counters():
    def busy(seconds):
        t = time.perf_counter() + seconds
        while time.perf_counter() < t:
            pass

    def run():
        with tracing.span("outer.a", 7):
            busy(0.002)
            for _ in range(2):
                with tracing.span("inner.b"):
                    busy(0.003)
                    with tracing.span("leaf.c"):
                        busy(0.001)
            tracing.count("kernel.fused_pair_fwd", 3)

    launched = kernels.LAUNCHES["fused_pair_fwd"]
    w = window_of(run)
    assert kernels.LAUNCHES["fused_pair_fwd"] == launched + 3
    assert w.counters == {"kernel.fused_pair_fwd": 3}
    a, b, c = (w.spans[n] for n in ("outer.a", "inner.b", "leaf.c"))
    assert (a.calls, b.calls, c.calls) == (1, 2, 2)
    assert a.stream_s is None                     # no card, host time only
    assert a.host_s >= 0.010 and c.host_s >= 0.002
    assert a.host_self_s == pytest.approx(a.host_s - b.host_s, abs=1e-9)
    assert b.host_self_s == pytest.approx(b.host_s - c.host_s, abs=1e-9)
    assert w.children[("outer.a", "inner.b")].calls == 2
    assert ("outer.a", "leaf.c") not in w.children
    assert w.within[("outer.a", "leaf.c")].host_s == pytest.approx(c.host_s)
    assert w.inside(("outer.",), ("leaf.",), "host") == \
        pytest.approx(c.host_s)
    assert w.total(("inner.", "leaf."), "host") == \
        pytest.approx(b.host_s + c.host_s)
    rec = {r.name: r for r in w.records}
    assert rec["outer.a"].id == 7 and rec["outer.a"].parent == -1
    assert rec["leaf.c"].parent == rec["inner.b"].seq
    assert all(r.t0_ns <= r.t1_ns for r in w.records)


def test_profiler_window_and_its_clock():
    before = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("md.p", 1):
            with tracing.span("node.q", 2):
                torch.ones(8).sum()
    with tracing.span("md.after"):       # closes the window, unrecorded
        pass
    assert tracing.span("md.later") is tracing.NOOP
    w = tracing.last_window()
    assert set(w.spans) == {"md.p", "node.q"}
    start = prof.profiler.kineto_results.trace_start_ns()
    assert start >= before - 10 ** 9
    ann = {e.name: e for e in prof.events() if tracing.is_user_annotation(e)}
    assert set(ann) >= {"md.p", "node.q"}
    for r in w.records:
        t0 = start + 1e3 * ann[r.name].time_range.start
        assert abs(t0 - r.t0_ns) < 2e6               # within 2 ms
    assert not any(tracing.is_user_annotation(e) for e in prof.events()
                   if e.name.startswith("aten::"))


def test_every_node_has_forward_and_backward_spans(trp):
    system, pos = trp
    x = pos[None].repeat(2, 1, 1)
    with torch.enable_grad():
        xg = x.clone().requires_grad_(True)
        total, outs, per_term, _ = system.evaluate(xg)
        named = {k: v for k, v in {**outs, **per_term}.items()
                 if k != "pos" and v.requires_grad}
        grads = torch.autograd.grad(total.sum(), list(named.values()),
                                    allow_unused=True)
    reached = {k for k, g in zip(named, grads) if g is not None}
    w = window_of(lambda: system.deriv(x, n_deriv_evals=5))
    names = {s.name for s in system.specs}
    assert {n for n in names if f"node.{n}" in w.spans} == names
    assert {n for n in names if f"node.{n}.bwd" in w.spans} == reached
    assert len(reached) > len(names) // 2
    for k in ("fused_pair", "fused_pair.bwd", "bp.plain", "bp.bwd"):
        assert w.spans[k].calls == 1
    assert {r.id for r in w.records if r.name.startswith("node.")} == {5}
    # a backward span sits inside the evaluation's backward pass
    ev = [r for r in w.records if r.name == "node.rotamer.bwd"][0]
    fwd = [r for r in w.records if r.name == "node.rotamer"][0]
    assert ev.t0_ns >= fwd.t1_ns


def test_advance_bitwise_equal_with_spans_on(trp):
    system, pos = trp
    sim = Simulation(system, dt=0.009, thermostat_interval=0.027, seed=1)
    st = sim.initial_state(pos, 2, 0.85)

    def noise(nr):
        g = torch.Generator().manual_seed(nr)
        return torch.randn((2,) + tuple(pos.shape), generator=g)

    off = sim.advance(st, 2, noise=noise)
    on = []
    w = window_of(lambda: on.append(sim.advance(st, 2, noise=noise)))
    assert torch.equal(off.pos, on[0].pos) and torch.equal(off.mom,
                                                           on[0].mom)
    assert w.evals == 6 and w.spans["md.round"].calls == 2
    assert w.spans["md.thermostat"].calls == 2
    assert {r.id for r in w.records if r.name == "md.eval"} == set(
        range(1, 7))
    g0, e0, _ = system.deriv(off.pos, off.cache)
    tracing.enable()
    g1, e1, _ = system.deriv(off.pos, off.cache)
    tracing.disable()
    assert torch.equal(g0, g1) and torch.equal(e0, e1)


def test_counters_are_the_recorders(trp):
    assert kernels.LAUNCHES is tracing.LAUNCHES
    assert bp_pairs.HOST_SYNCS is tracing.HOST_SYNCS
    system, pos = trp
    n0 = bp_pairs.HOST_SYNCS["bp_solve_plain"]
    w = window_of(lambda: system.deriv(pos[None]))
    n = bp_pairs.HOST_SYNCS["bp_solve_plain"] - n0
    assert n > 0 and w.counters["sync.bp_solve_plain"] == n
    assert w.spans["sync.bp_solve_plain"].calls == n
    assert w.children[("bp.plain", "sync.bp_solve_plain")].calls == n
    m0 = bp_pairs.HOST_SYNCS["bp_solve_plain"]
    system.deriv(pos[None])                       # off: counted, no span
    assert bp_pairs.HOST_SYNCS["bp_solve_plain"] > m0


# the neighbour lists' sites on trp-cage once their thresholds are lowered
LIST_SITES = ("rotamer", "hbond_coverage", "hbond_coverage_hydrophobe")


def lists_system(monkeypatch, lists=True):
    """trp-cage without its fused block: on the neighbour lists (their
    thresholds lowered below its 96 beads and columns; read at call time)
    or on the dense unfused path."""
    from upside_md_torch import system as psystem
    from upside_md_torch.nodes import hbond, rotamer
    monkeypatch.setattr(psystem, "plan_pair_fusion", lambda specs: None)
    if lists:
        monkeypatch.setattr(rotamer, "NEIGHBOR_LIST_THRESHOLD", 64)
        monkeypatch.setattr(hbond, "COVERAGE_NL_THRESHOLD", 64)
    return System.from_bundle(TRP, "cpu")


def changed(before):
    return {k: v - before.get(k, 0) for k, v in tracing.counters().items()
            if v != before.get(k, 0)}


def test_neighbour_list_spans_and_counter(monkeypatch):
    """One `deriv` builds three lists, each counted once and spanned
    `nlist.<site>` inside its node's span, with its build nested
    (`nlist.build`) and a backward span; the spans add no host sync and
    leave energy and forces bitwise unchanged."""
    system, pos = lists_system(monkeypatch)
    x = pos[None] + 0.05 * torch.randn(
        (2,) + tuple(pos.shape), generator=torch.Generator().manual_seed(5))
    before = tracing.counters()
    g0, e0, _ = system.deriv(x)
    off = changed(before)
    on = []
    w = window_of(lambda: on.append(system.deriv(x)))
    assert torch.equal(g0, on[0][0]) and torch.equal(e0, on[0][1])
    assert {k: n for k, n in off.items() if k.startswith("nlist.")} == {
        f"nlist.{s}": 1 for s in LIST_SITES}
    # the same counters move, host syncs included, with the spans on
    assert w.counters == off
    assert off["sync.bp_solve_plain"] > 0
    for s in LIST_SITES:
        assert w.spans[f"nlist.{s}"].calls == 1, s
        assert w.spans[f"nlist.{s}.bwd"].calls == 1, s
        assert w.children[(f"node.{s}", f"nlist.{s}")].calls == 1, s
        assert w.children[(f"nlist.{s}", "nlist.build")].calls == 1, s
    assert w.spans["nlist.build"].calls == len(LIST_SITES)
    assert tracing.is_user_annotation(types.SimpleNamespace(
        name="nlist.rotamer"))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_dense_paths_open_no_list_span(trp, monkeypatch, fused):
    system, pos = trp if fused else lists_system(monkeypatch, lists=False)
    before = tracing.counters()
    w = window_of(lambda: system.deriv(pos[None]))
    assert not any(n.startswith("nlist.") for n in w.spans)
    assert not any(k.startswith("nlist.") for k in changed(before))


def test_training_step_spans_and_chrome_file(trp, tmp_path):
    system, pos = trp
    ens = pos[None] + 0.01 * torch.randn(
        (3,) + tuple(pos.shape), generator=torch.Generator().manual_seed(3))
    loss = training.contrastive_divergence_loss(system, pos, ens)
    trainable, frozen = training.select_trainable(
        system.params, ["rotamer", "hbond_coverage"])
    w = window_of(lambda: training.fit(loss, trainable, frozen, n_steps=2))
    assert w.steps == 2 and w.evals == 0
    for k in ("train.loss", "train.backward", "train.adam",
              "sync.train_loss", "sync.fusion_tables", "fused_pair.prepare"):
        assert w.spans[k].calls == 2, k
    # two energies a step (the native's and the ensemble's), two tables
    assert w.spans["cotangent.table"].calls == 8
    assert w.spans["cotangent.identity_edge"].calls == 4
    assert w.inside(("train.step",), ("sync.",), "host") == \
        pytest.approx(w.total(("sync.",), "host"))
    path = tracing.write_chrome(str(tmp_path / "spans.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert len(events) == len(w.records)
    now_us = time.time_ns() / 1e3
    assert all(now_us - 600e6 < e["ts"] <= now_us and e["dur"] >= 0
               for e in events)
    assert {e["args"]["id"] for e in events if e["name"] == "train.step"} \
        == {0, 1}
