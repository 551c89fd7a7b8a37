"""The port's sampling loop against the JAX package on the trp-cage
bundle: force clipping, the integrators' weights and recentering,
Hamiltonian ensembles (`stack_param_ensembles`, per-slot energies and
forces of stacked leaves, stacked kernel tables run once a slot), the
annealing schedule, and the order of a round (MC moves, thermostat,
integration) over a few rounds fed the JAX package's own draws.  float64
throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mc import pivot_tables
from test_torch_nodes import TRP, load_pair
from upside_md_tpu.md import integrator as jint
from upside_md_tpu.md import sim as jsim
from upside_md_tpu.md.mc import PivotSampler as JPivot
from upside_md_tpu.md.thermostat import (PIVOT_MOVE_STREAM,
                                         THERMOSTAT_STREAM, stream_key)
from upside_md_torch.md import integrator
from upside_md_torch.md.mc import PivotSampler
from upside_md_torch.md.sim import (Simulation, param_axes,
                                    stack_param_ensembles)
from upside_md_torch.system import System, slot_params

# (node, leaf) stacked per case: the spring ladder of the replica-exchange
# configuration, and one leaf of every other plain node type
LADDER = (("angle_spring", "spring_const"),)
PLAIN_LEAVES = (("dihedral_spring", "equil_dihedral"),
                ("dist_spring", "spring_const"), ("rama_map_pot", "coeffs"),
                ("placement_fixed_point_vector_only", "placement_data"),
                ("placement_scalar", "coeffs"),
                ("protein_hbond", "interaction_param"),
                ("hbond_energy", "protein_hbond_energy"),
                ("nonlinear_coupling_environment", "coeff"))
# the fused block's four tables (hbond and hydrophobe coverage, rotamer
# pairs, environment)
KERNEL_TABLES = (("hbond_coverage", "interaction_param"),
                 ("hbond_coverage_hydrophobe", "interaction_param"),
                 ("rotamer", "interaction_param"),
                 ("environment_coverage", "interaction_param"))
N_SLOT = 3


@pytest.fixture(scope="module")
def trp():
    records, pos, js, jp, ts = load_pair(TRP)
    rng = np.random.default_rng(21)
    P = pos.astype(np.float64) + 0.05 * rng.normal(size=(N_SLOT,) + pos.shape)
    # one compiled value-and-gradient, shared by every slot and case
    vg = jax.jit(jax.value_and_grad(js.energy))
    return dict(records=records, pos=pos, js=js, jp=jp, ts=ts, P=P, vg=vg)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _slots(ts, jp, leaves, n=N_SLOT):
    """Per-slot parameter sets, port and JAX, with each of `leaves` scaled
    by 1 + 0.02 (i / (n - 1) - 0.5) in slot i (the +-1% ladder)."""
    port, ref = [], []
    for i in range(n):
        f = 1.0 + 0.02 * (i / (n - 1) - 0.5)
        p = {k: dict(v) for k, v in ts.params.items()}
        q = {k: dict(v) for k, v in jp.items()}
        for node, leaf in leaves:
            p[node][leaf] = ts.params[node][leaf] * f
            q[node][leaf] = jp[node][leaf] * f
        port.append(p)
        ref.append(q)
    return port, ref


def _keystr(node, leaf):
    return f"['{node}']['{leaf}']"


def test_clip_force_predescu_recenter_match_jax():
    rng = np.random.default_rng(1)
    d = 4.0 * rng.normal(size=(3, 17, 3))
    for max_force in (0.0, 0.7, 3.0):
        got = integrator.clip_force(torch.tensor(d), max_force).numpy()
        want = np.asarray(jint.clip_force(jnp.asarray(d), max_force))
        assert _rel(got, want) < 1e-6
    clipped = integrator.clip_force(torch.tensor(d), 0.7)
    assert clipped.pow(2).sum(-1).sqrt().max() < 0.7
    for name in ("verlet", "predescu"):
        for ours, ref in zip(integrator.INTEGRATOR_COEFFS[name],
                             jint.INTEGRATOR_COEFFS[name]):
            np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)
    assert integrator.INTEGRATOR_COEFFS["verlet"] == ((1.0,) * 3,) * 2
    pos = 10.0 * rng.normal(size=(2, 30, 3))
    for xy in (False, True):
        got = integrator.recenter(torch.tensor(pos), xy).numpy()
        want = np.asarray(jint.recenter(jnp.asarray(pos), xy))
        assert _rel(got, want) < 1e-6
    assert np.abs(got.mean(1)[:, :2]).max() < 1e-12
    np.testing.assert_array_equal(got[..., 2], pos[..., 2])


def test_verlet_round_without_clipping_is_unchanged():
    """Verlet with max_force 0 gives exactly mom - dt*d, pos + dt*mom per
    stage, as the round did before clipping and the Predescu weights."""
    rng = np.random.default_rng(2)
    pos = torch.tensor(rng.normal(size=(2, 11, 3)))
    mom = torch.tensor(rng.normal(size=(2, 11, 3)))
    k = torch.tensor(rng.uniform(0.5, 2.0, size=(11, 1)))

    def deriv(p, stage, cache):
        return k * p + 0.1 * p.pow(3), cache + [stage]

    got = integrator.integration_cycle(deriv, pos, mom, 0.009, [])
    p, m = pos, mom
    for stage in range(3):
        d, _ = deriv(p, stage, [])
        m = m - 0.009 * d
        p = p + 0.009 * m
    assert torch.equal(got[0], p) and torch.equal(got[1], m)
    assert got[2] == [0, 1, 2]
    pred = integrator.integration_cycle(deriv, pos, mom, 0.009, [],
                                        max_force=0.5, integrator="predescu")
    jp_, jm = jint.integration_cycle(
        lambda q, s: jnp.asarray(k.numpy()) * q + 0.1 * q ** 3,
        jnp.asarray(pos.numpy()), jnp.asarray(mom.numpy()), 0.009, 0.5,
        "predescu")
    assert _rel(pred[0].numpy(), jp_) < 1e-6
    assert _rel(pred[1].numpy(), jm) < 1e-6


def test_stack_param_ensembles_matches_jax(trp):
    ts, jp = trp["ts"], trp["jp"]
    leaves = LADDER + PLAIN_LEAVES[:3] + KERNEL_TABLES[2:3]
    port, ref = _slots(ts, jp, leaves)
    mixed, spec = stack_param_ensembles(port)
    jmixed, jspec = jsim.stack_param_ensembles(ref)
    assert spec == frozenset(leaves)
    assert {_keystr(*leaf) for leaf in spec} == set(jspec)
    for node, leaf in spec:
        assert mixed[node][leaf].shape == (N_SLOT,) + \
            ts.params[node][leaf].shape
        np.testing.assert_array_equal(mixed[node][leaf].numpy(),
                                      np.asarray(jmixed[node][leaf]))
    # shared leaves stay slot 0's tensors
    assert mixed["hbond_coverage"]["interaction_param"] is \
        port[0]["hbond_coverage"]["interaction_param"]
    axes = param_axes(mixed, spec)
    jaxes = jsim.param_axes(jmixed, jspec)
    for node, leaves_ in axes.items():
        assert leaves_ == dict(jaxes.get(node, {})) or not leaves_
    assert param_axes(mixed, True) == 0 and param_axes(mixed, set()) is None
    # slots must define the same potentials
    bad = {k: dict(v) for k, v in port[1].items()}
    del bad["rama_map_pot"]["coeffs"]
    with pytest.raises(ValueError, match="slot 1"):
        stack_param_ensembles([port[0], bad])
    jbad = {k: dict(v) for k, v in ref[1].items()}
    del jbad["rama_map_pot"]["coeffs"]
    with pytest.raises(ValueError, match="slot 1"):
        jsim.stack_param_ensembles([ref[0], jbad])


@pytest.mark.parametrize("leaves", [LADDER, PLAIN_LEAVES],
                         ids=["spring_ladder", "plain_nodes"])
def test_per_slot_energies_and_forces_match_jax(trp, leaves):
    """Each slot's energy and force under stacked leaves, the port's one
    batched evaluation against the JAX package: energies from
    `vmap(system.energy, in_axes=(0, param_axes))`, forces from its
    gradient slot by slot under each slot's own parameters; rel 1e-5."""
    js, ts, jp, P = trp["js"], trp["ts"], trp["jp"], trp["P"]
    port, ref = _slots(ts, jp, leaves)
    mixed, spec = stack_param_ensembles(port)
    jmixed, jspec = jsim.stack_param_ensembles(ref)
    axes = jsim.param_axes(jmixed, jspec)
    e_j = jax.jit(jax.vmap(js.energy, in_axes=(0, axes)))(jnp.asarray(P),
                                                          jmixed)
    g_t, e_t, _ = ts.deriv(torch.tensor(P), None, None, mixed)
    assert _rel(e_t.numpy(), e_j) < 1e-5
    for i in range(N_SLOT):
        e_i, g_i = trp["vg"](jnp.asarray(P[i]), ref[i])
        assert abs(float(e_i) - float(e_j[i])) <= 1e-9 * abs(float(e_i))
        assert _rel(g_t[i].numpy(), g_i) < 1e-5
    # the slots really differ, and slot 1 is the unscaled system
    shared = ts.energy(torch.tensor(P)).numpy()
    assert np.ptp(e_t.numpy() - shared) > 1e-6
    assert abs(e_t[1].item() - shared[1]) <= 1e-12 * abs(shared[1])


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_stacked_kernel_tables_run_once_a_slot(trp, fused):
    """Stacked kernel tables run their kernel once a slot: the fused
    block's four with each slot's own operands, and unfused (the same
    graph with the fusion plan off: K4 for the coverages, K5 for the
    rotamer grid) the coverage and rotamer tables.  Each slot equals that
    slot evaluated alone under its own parameters (rel 1e-6); the shared
    tables keep one set of operands."""
    ts, jp, P = trp["ts"], trp["jp"], trp["P"]
    if not fused:
        ts = System(len(trp["pos"]), trp["records"], device="cpu",
                    dtype=torch.float64)
        ts.pair_fusion = None
    port, _ = _slots(ts, jp, KERNEL_TABLES)
    mixed, spec = stack_param_ensembles(port)
    prep = ts.fused_prepared(mixed)
    assert isinstance(prep, list) == fused
    assert not isinstance(ts.fused_prepared(), list)
    x = torch.tensor(P)
    g, e, cache = ts.deriv(x, None, None, mixed)
    for i in range(N_SLOT):
        gi, ei, ci = ts.deriv(x[i:i + 1], None, None,
                              slot_params(mixed, spec, i))
        assert _rel(e[i:i + 1].numpy(), ei.numpy()) < 1e-6
        assert _rel(g[i].numpy(), gi[0].numpy()) < 1e-6
        np.testing.assert_allclose(cache["rotamer"]["nb"][i].numpy(),
                                   ci["rotamer"]["nb"][0].numpy(),
                                   rtol=1e-6, atol=1e-12)
    assert np.ptp(e.numpy() - ts.energy(x).numpy()) > 1e-6


def test_anneal_temperature_matches_jax(trp):
    kw = dict(dt=0.009, duration=3.0, anneal_factor=0.4,
              anneal_duration=2.0)
    js_sim = jsim.Simulation(trp["js"], **kw)
    sim = Simulation(trp["ts"], **kw)
    t0 = np.array([0.8, 1.1, 1.6])
    for nr in range(0, sim.n_round + 8, 5):
        got = sim._anneal_temperature(torch.tensor(t0), nr).numpy()
        want = np.asarray(js_sim._anneal_temperature(jnp.asarray(t0), nr))
        assert _rel(got, want) < 1e-6, nr
    assert np.allclose(sim._anneal_temperature(torch.tensor(t0), 0).numpy(),
                       t0)
    end = sim._anneal_temperature(torch.tensor(t0), sim.n_round).numpy()
    np.testing.assert_allclose(end, 0.4 * t0, rtol=1e-12)


def test_round_order_with_jax_draws(trp):
    """Four rounds of MC (every 2 rounds, not at round 0), thermostat
    (every round) and Verlet from the same state, the port fed the JAX
    package's thermostat noise and pivot draws: positions atol 1e-5."""
    js, jp, ts, records = trp["js"], trp["jp"], trp["ts"], trp["records"]
    P = trp["P"][:2]
    tables = pivot_tables(records, len(trp["pos"]), seed=5)
    temps = np.array([0.85, 1.05])
    seed, rounds = 17, 4
    kw = dict(dt=0.009, thermostat_interval=0.027, mc_interval=0.0675)
    jsim_ = jsim.Simulation(js, pivot_sampler=JPivot.from_tables(*tables),
                            do_recenter=False, **kw)
    sim = Simulation(ts, pivot_sampler=PivotSampler.from_tables(
        *tables, device="cpu"), do_recenter=False, **kw)
    assert sim.mc_interval == jsim_.mc_interval == 2
    jstate = jsim_.initial_state(jnp.asarray(P), jp, seed=seed,
                                 temperature=temps, n_replica=2)
    jout = jsim_.advance(jstate, jp, rounds, batched=True)

    def noise(nr):
        return torch.tensor(np.stack([np.asarray(jax.random.normal(
            stream_key(seed + i, THERMOSTAT_STREAM, nr + 1), P.shape[1:],
            jnp.float64)) for i in range(2)]))

    def mc_draws(nr, kind):
        assert kind == "pivot"
        u, acc = [], []
        for i in range(2):
            k_prop, k_acc = jax.random.split(
                stream_key(seed + i, PIVOT_MOVE_STREAM, nr))
            u.append(np.asarray(jax.random.uniform(k_prop, (4,),
                                                   jnp.float64)))
            acc.append(float(jax.random.uniform(k_acc, dtype=jnp.float64)))
        return torch.tensor(np.stack(u)), torch.tensor(acc)

    state = sim.initial_state(P, 2, temps)
    state.mom = torch.tensor(np.asarray(jstate.mom))
    out = sim.advance(state, rounds, noise=noise, mc_draws=mc_draws)
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(jout.pos),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out.pivot_stats.numpy(),
                                  np.asarray(jout.pivot_stats))
    assert out.pivot_stats[:, 1].tolist() == [1, 1]
    assert out.round_num == rounds


def test_initial_state_takes_a_temperature_per_replica(trp):
    """One temperature per replica (sim.py:132-164): each replica's
    momenta drawn at its own, the annealing start kept beside it; a scalar
    still reaches every replica."""
    sim = Simulation(trp["ts"], seed=5)
    temps = [0.25, 1.0, 4.0]
    # 400 copies of the atoms, so that each replica's momentum variance is
    # sharp (initial_state evaluates nothing)
    state = sim.initial_state(np.tile(trp["P"][0], (400, 1)), 3, temps)
    np.testing.assert_array_equal(state.temperature.numpy(), temps)
    np.testing.assert_array_equal(state.initial_temperature.numpy(), temps)
    var = state.mom.reshape(3, -1).var(1).numpy()
    np.testing.assert_allclose(var / temps, 1.0, rtol=0.1)
    assert state.pivot_stats.shape == state.jump_stats.shape == (3, 2)
    one = sim.initial_state(trp["P"][0], 2, 0.85)
    np.testing.assert_array_equal(one.temperature.numpy(), [0.85, 0.85])


def test_energy_only_evaluations_keep_no_residual(trp, monkeypatch):
    """The energies of MC moves and replica swaps (grad mode off) run the
    fused block's forward without its residual; a force evaluation keeps
    it for the backward."""
    from upside_md_torch.ops import fused_pair
    asked = []
    fwd = fused_pair.fused_pair_fwd

    def spy(prep, *args, **kw):
        asked.append(args[5] if len(args) > 5 else kw.get("want_planes"))
        return fwd(prep, *args, **kw)

    monkeypatch.setattr(fused_pair, "fused_pair_fwd", spy)
    ts, x = trp["ts"], torch.tensor(trp["P"])
    sim = Simulation(ts)
    e = sim.energy_fn(ts.params)(x)
    g, e2, _ = ts.deriv(x)
    assert asked == [False, True]
    assert torch.equal(e, e2)
