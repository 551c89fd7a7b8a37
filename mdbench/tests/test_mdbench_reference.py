"""The plain reference agrees with the program's CPU path at small size:
energies, forces and table gradients of the full force field, on the fused
path and on the unfused path with the plain BP solve (the thresholds that
choose them lowered, as the program's own tests lower them)."""

import numpy as np
import pytest
import torch

from mdbench import harness
from mdbench.reference import train as ref_train
from mdbench.reference.forcefield import ForceField, load_bundle
from mdbench.tests.tiny import CPU

BUNDLE = harness.bundle_path({"bundle": "trp_cage_full_synth"})
TABLES = ("rotamer", "hbond_coverage", "hbond_coverage_hydrophobe")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def program(monkeypatch, path):
    """The program's System in float64 on the CPU, its BP converged as far
    as the reference's, on the fused or the unfused planes path."""
    from upside_md_torch import system as psystem
    from upside_md_torch.config import bundle
    from upside_md_torch.nodes import rotamer
    from upside_md_torch.ops import bp_pairs, bp_planes
    if path == "planes":
        monkeypatch.setattr(psystem, "plan_pair_fusion", lambda specs: None)
        monkeypatch.setattr(rotamer, "PAIRS_KERNEL_MAX_BEADS", 16)
        monkeypatch.setattr(bp_pairs, "MAX_RES", 8)
        monkeypatch.setattr(bp_planes, "MAX_RES", 8)
    specs, pos = bundle.load(BUNDLE)
    for s in specs:
        if s.type_name == "rotamer":
            s.consts = dict(s.consts, tol=1e-11, max_iter=20000)
    return psystem.System(len(pos), specs, device="cpu",
                          dtype=torch.float64), pos


def configurations(pos, n=3, seed=4):
    g = torch.Generator().manual_seed(seed)
    x = torch.as_tensor(pos, dtype=torch.float64)
    return x + 0.1 * torch.randn((n,) + x.shape, generator=g,
                                 dtype=torch.float64)


@pytest.mark.parametrize("path", ["fused", "planes"])
def test_energy_and_forces(monkeypatch, path):
    prog, pos = program(monkeypatch, path)
    x = configurations(pos)
    g_p, e_p, _ = prog.deriv(x)
    nodes, _ = load_bundle(BUNDLE)
    ff = ForceField(nodes, CPU, torch.float64, tol=1e-12)
    e_r, g_r = ff.energy(x), ff.gradient(x)
    assert torch.allclose(e_r, e_p, rtol=1e-9, atol=0)
    assert ((g_r - g_p).norm() / g_p.norm()).item() < 1e-8


def test_table_gradients(monkeypatch):
    prog, pos = program(monkeypatch, "fused")
    x = configurations(pos, n=2, seed=9)
    nodes, _ = load_bundle(BUNDLE)
    ff = ForceField(nodes, CPU, torch.float64, tol=1e-12)
    tables = {n: ff.params[n]["interaction_param"] for n in TABLES}
    loss, grad = ref_train.loss_and_grad(ff, tables, x[0], x[1:],
                                         block=1)
    e = prog.energy(x)
    want_loss = float(e[0] - e[1])        # one configuration: F = E
    # a difference of two energies of ~200: held to their scale
    assert abs(loss - want_loss) <= 1e-10 * float(e.abs().max())
    for n in TABLES:
        want = prog.param_deriv(x[:1], n)["interaction_param"] \
            - prog.param_deriv(x[1:], n)["interaction_param"]
        got = grad[n]
        assert ((got - want).norm() / want.norm()).item() < 1e-7, n


def test_bp_fixed_point_is_the_programs():
    """The reference's BP reaches the program's plain solve's fixed point
    on a random rotamer problem."""
    from upside_md_torch.ops.bp_pairs import (bethe_and_gradients,
                                              bp_solve_plain,
                                              node_potentials)
    from mdbench.reference import bp
    rng = np.random.default_rng(3)
    B, R = 2, 7
    valid = torch.as_tensor(rng.random((R, 6)) < 0.7)
    valid[:, 0] = True
    E1 = torch.as_tensor(rng.normal(size=(B, R, 6)))
    U = torch.as_tensor(rng.normal(scale=0.5, size=(B, R, R, 6, 6)))
    E2 = U + U.permute(0, 2, 1, 4, 3)
    E2 = E2 * (1 - torch.eye(R, dtype=E2.dtype))[None, :, :, None, None]
    pv = valid[:, None, :, None] & valid[None, :, None, :]
    P = torch.where(pv, torch.exp(-E2), torch.zeros_like(E2))
    adj = ~torch.eye(R, dtype=torch.bool).expand(B, R, R)
    offset, prob = node_potentials(E1, valid)
    nb, eb, _, _ = bp_solve_plain(prob, P, adj, valid, 0.1, 20000, 1e-12, 2)
    F, _, _ = bethe_and_gradients(E1, offset, prob, P, adj, valid, nb, eb)
    got = bp.free_energy(E1, E2, valid, 0.1, 1e-12, 20000)
    # the program's logs carry an EPS of 1e-10 that the reference's lack
    assert torch.allclose(got, F, rtol=0, atol=1e-7)
