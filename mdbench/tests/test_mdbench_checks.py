"""The comparison that decides `correct` fails where it should, at a size
a test run holds (the cells' own limits, tiny variants of their inputs):

* the control, the reference computed in bfloat16 in the program's place;
* a run whose timed path is broken underneath, for each fault a cell can
  have: a step that returns its state unchanged, half of the batch left
  out, an answer altered where it is produced (the forces, or the
  energies, half as large again).  No cell spans chips, so none can leave
  out an exchange between them;
* an MD run in which only the batch's last replica is wrong, which the
  75th percentiles pass and the counts over the caps fail.
"""

import dataclasses

import pytest
import torch

from mdbench import harness
from mdbench.tests.tiny import MD_CELLS, TRAIN_CELLS, run_once, tiny


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", MD_CELLS + TRAIN_CELLS)
def test_sound_run_is_correct_and_control_is_not(cell):
    wl = tiny(cell)
    run, result = run_once(wl)
    assert result["correct"], result["checks"]
    control = run.control()
    assert not harness.judge(control, wl["limits"])[0], control


def _md_fault(monkeypatch, fault):
    from upside_md_torch.md.sim import Simulation
    from upside_md_torch.system import System
    advance, deriv = Simulation.advance, System.deriv

    def unchanged(self, state, n_rounds, **kw):
        return dataclasses.replace(state,
                                   round_num=state.round_num + n_rounds)

    def half(self, state, n_rounds, **kw):
        new = advance(self, state, n_rounds, **kw)
        h = state.pos.shape[0] // 2
        return dataclasses.replace(
            new, pos=torch.cat([new.pos[:h], state.pos[h:]]),
            mom=torch.cat([new.mom[:h], state.mom[h:]]))

    def altered(self, *a, **kw):
        g, e, c = deriv(self, *a, **kw)
        return 1.5 * g, e, c

    if fault == "altered":
        monkeypatch.setattr(System, "deriv", altered)
    else:
        monkeypatch.setattr(Simulation, "advance",
                            {"unchanged": unchanged, "half": half}[fault])


def _train_fault(monkeypatch, fault):
    from upside_md_torch import training
    from upside_md_torch.system import System
    cd, adam, energy = (training.contrastive_divergence_loss,
                        training._adam, System.energy)

    class NoStep:
        def __init__(self, opt):
            self.opt = opt

        def zero_grad(self):
            self.opt.zero_grad()

        def step(self):
            pass

    if fault == "unchanged":
        monkeypatch.setattr(training, "_adam",
                            lambda leaves, lr: NoStep(adam(leaves, lr)))
    elif fault == "half":
        monkeypatch.setattr(
            training, "contrastive_divergence_loss",
            lambda s, n, ens, t=1.0: cd(s, n, ens[:len(ens) // 2], t))
    else:
        monkeypatch.setattr(System, "energy",
                            lambda self, *a, **kw: 1.5 * energy(
                                self, *a, **kw))


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", MD_CELLS + TRAIN_CELLS)
def test_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    wl = tiny(cell)
    (_md_fault if wl["mode"] == "md" else _train_fault)(monkeypatch, fault)
    _, result = run_once(wl)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", MD_CELLS)
def test_one_wrong_replica_is_not_correct(monkeypatch, cell):
    from upside_md_torch.system import System
    deriv = System.deriv

    def last_altered(self, *a, **kw):
        g, e, c = deriv(self, *a, **kw)
        g = g.clone()
        g[-1] = 1.5 * g[-1]
        return g, e, c

    monkeypatch.setattr(System, "deriv", last_altered)
    wl = tiny(cell)
    wl.update(replicas=8, check_replicas=8)
    run, result = run_once(wl, seconds=1.5)
    checks = result["checks"]
    assert len(run.checked_chunks(run.window[3])) >= 2
    assert checks["pos_gap_p75"]["value"] <= checks["pos_gap_p75"]["limit"]
    assert checks["mom_gap_p75"]["value"] <= checks["mom_gap_p75"]["limit"]
    assert not result["correct"], checks
