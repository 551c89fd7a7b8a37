"""The program on its fixed-K neighbour lists, as GFP takes them past 1,024
beads and columns, against the plain reference, and the readers of the
lists' spans and counter.  On the CPU at trp-cage's size: its 96 beads and
columns take the lists once their thresholds are lowered (the program
reads them at call time), with the fused block off and the planes path
with the plain BP solve, as GFP's 238 residues take it.

* At K = 40 no row overflows: energies and forces agree with the dense
  reference at the tolerances of `test_mdbench_reference.py`.
* At K = 8 rows overflow, and the partners the lists drop fail them.
* A tiny run of `gfp_full.ens64`'s workload reads `correct` true; under
  its limits the bfloat16 control and lists cut to K = 4 do not.
* The three readers read a window of it: three lists an evaluation, each
  second of a list counted once (its nested build not again); a window
  without lists, or a program without the recorder, reads nothing.
"""

import sys
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mdbench import harness
from mdbench.reference.forcefield import ForceField, load_bundle
from mdbench.tests.tiny import CPU, run_once, tiny

CELL = "gfp_full.ens64"
BUNDLE = harness.bundle_path({"bundle": "trp_cage_full_synth"})
READERS = ("nlist_ms_per_eval", "nlist_roofline", "nlist_builds_per_eval")
SITES = ("rotamer", "hbond_coverage", "hbond_coverage_hydrophobe")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def on_lists(monkeypatch, K=None):
    """The program takes GFP's path on trp-cage: the neighbour lists (of
    width K for the rotamer grid and both coverages, if given), the planes
    path and the plain BP solve."""
    from upside_md_torch import system as psystem
    from upside_md_torch.nodes import hbond, rotamer
    from upside_md_torch.ops import bp_pairs, bp_planes
    monkeypatch.setattr(psystem, "plan_pair_fusion", lambda specs: None)
    monkeypatch.setattr(rotamer, "PAIRS_KERNEL_MAX_BEADS", 16)
    monkeypatch.setattr(bp_pairs, "MAX_RES", 8)
    monkeypatch.setattr(bp_planes, "MAX_RES", 8)
    monkeypatch.setattr(rotamer, "NEIGHBOR_LIST_THRESHOLD", 64)
    monkeypatch.setattr(hbond, "COVERAGE_NL_THRESHOLD", 64)
    if K is not None:
        monkeypatch.setattr(rotamer, "NEIGHBOR_K", K)
        monkeypatch.setattr(hbond, "COVERAGE_NEIGHBOR_K", K)


def program(monkeypatch, K):
    """The program's System in float64 on the CPU on the lists, its BP
    converged as far as the reference's."""
    from upside_md_torch import system as psystem
    from upside_md_torch.config import bundle
    on_lists(monkeypatch, K)
    specs, pos = bundle.load(BUNDLE)
    for s in specs:
        if s.type_name == "rotamer":
            s.consts = dict(s.consts, tol=1e-11, max_iter=20000)
    return psystem.System(len(pos), specs, device="cpu",
                          dtype=torch.float64), pos


@pytest.mark.parametrize("K,agrees", [(40, True), (8, False)],
                         ids=["no_overflow", "overflow"])
def test_lists_against_the_reference(monkeypatch, K, agrees):
    from upside_md_torch import tracing
    prog, pos = program(monkeypatch, K)
    g = torch.Generator().manual_seed(4)
    x = torch.as_tensor(pos, dtype=torch.float64)
    x = x + 0.1 * torch.randn((3,) + x.shape, generator=g,
                              dtype=torch.float64)
    before = tracing.counters()
    g_p, e_p, _ = prog.deriv(x)
    built = {k: n - before.get(k, 0) for k, n in tracing.counters().items()
             if k.startswith("nlist.")}
    assert built == {f"nlist.{s}": 1 for s in SITES}
    nodes, _ = load_bundle(BUNDLE)
    ff = ForceField(nodes, CPU, torch.float64, tol=1e-12)
    e_r, g_r = ff.energy(x), ff.gradient(x)
    energy_rel = float(((e_p - e_r) / e_r).abs().max())
    force_rel = float((g_r - g_p).norm() / g_p.norm())
    if agrees:
        assert energy_rel <= 1e-9 and force_rel < 1e-8
    else:
        assert energy_rel > 1e-9 and force_rel > 1e-8


def test_tiny_run_is_correct(monkeypatch):
    on_lists(monkeypatch)
    _, res = run_once(tiny(CELL))
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0


def traced_window(monkeypatch, lists=True):
    """A traced window of the tiny cell under a CPU `torch.profiler`, as a
    traced run's window opens the recorder, as the readers see it: the
    evaluations and the chunk's positions at its start and end."""
    if lists:
        on_lists(monkeypatch)
    wl = tiny(CELL)
    run = harness.load_module("modes", wl["mode"]).Run(wl, CPU, 2 ** 40 + 9)
    sim, state, noise = run._program()
    state = sim.advance(state, 1, noise=noise)
    start = state.pos.clone()
    with profile(activities=[ProfilerActivity.CPU]):
        state = sim.advance(state, wl["chunk_rounds"], noise=noise)
    evals = 3 * wl["chunk_rounds"]
    nodes, _ = load_bundle(harness.bundle_path(wl["config"]))
    return types.SimpleNamespace(evals=evals, extra={
        "ff": ForceField(nodes, CPU, torch.float64),
        "replicas": wl["replicas"],
        "chunks": [(start, state.pos.clone(), evals)]})


def test_readers_of_the_lists(monkeypatch):
    from upside_md_torch import tracing
    traced = traced_window(monkeypatch)
    w = tracing.last_window()
    read = {n: harness.load_module("metrics", n).read(traced)
            for n in READERS}
    assert read["nlist_builds_per_eval"] == len(SITES)
    once = sum(w.spans[f"nlist.{s}{b}"].time() for s in SITES
               for b in ("", ".bwd"))
    assert w.spans["nlist.build"].calls == len(SITES) * traced.evals
    assert w.spans["nlist.build"].time() > 0
    assert read["nlist_ms_per_eval"] == pytest.approx(
        1e3 * once / traced.evals, rel=1e-12)
    assert 0 < read["nlist_roofline"] < 100
    for name in READERS:
        with pytest.raises(RuntimeError):
            harness.load_module("metrics", name).read(
                types.SimpleNamespace(evals=traced.evals + 1))


def test_readers_read_nothing_without_lists(monkeypatch):
    # a window on the dense path: the parent commit's spans and counters
    traced = traced_window(monkeypatch, lists=False)
    for name in READERS:
        assert harness.load_module("metrics", name).read(traced) is None
    # a program without the recorder
    import upside_md_torch
    monkeypatch.delattr(upside_md_torch, "tracing")
    monkeypatch.setitem(sys.modules, "upside_md_torch.tracing", None)
    for name in READERS:
        assert harness.load_module("metrics", name).read(traced) is None


@pytest.mark.parametrize("planted", ["control", "overflow"])
def test_tiny_control_and_overflow_are_not_correct(monkeypatch, planted):
    """Under the cell's limits the control (the reference in bfloat16 in
    the program's place) fails, and so do lists cut to K = 4, whose rows
    overflow (at trp-cage's size and 2 rounds a chunk, K = 8 reads barely
    above the limits, K = 4 twice them)."""
    on_lists(monkeypatch, 4 if planted == "overflow" else None)
    wl = tiny(CELL)
    run, res = run_once(wl)
    readings = run.control() if planted == "control" else {
        k: c["value"] for k, c in res["checks"].items()}
    assert not harness.judge(readings, wl["limits"])[0], readings
