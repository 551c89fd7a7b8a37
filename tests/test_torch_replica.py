"""The port's replica exchange (upside_md_torch/md/replica.py) and its run
loop (`upside_md_torch.cli.run_ensemble`) against the JAX package:

* `parse_swap_sets` (its validation errors) and `even_odd_swap_sets`;
* `attempt_swaps` over several exchange rounds on the acceptance
  uniforms JAX draws from the same key splits, in Hamiltonian and
  `slot_independent` modes: positions, energies, `replica_index`, stats
  and the permuted warm-start cache all equal;
* one Hamiltonian exchange round of the trp-cage system under a stacked
  spring ladder, the port's energies against JAX `vmap(system.energy)`;
* `run_ensemble`'s event rounds against the command line's loop
  (cli.py:253-263), and a short run of the whole loop on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_nodes import TRP, load_pair
from upside_md_tpu.md import replica as jrep
from upside_md_tpu.md import sim as jsim
from upside_md_torch.cli import event_rounds, run_ensemble
from upside_md_torch.md.replica import (ReplicaExchange, even_odd_swap_sets,
                                        parse_swap_sets)
from upside_md_torch.md.sim import Simulation, stack_param_ensembles

B = 6


def test_parse_swap_sets_and_its_errors_match_jax():
    good = ["0-1,2-3,4-5", "1-2,3-4"]
    assert parse_swap_sets(good, B) == jrep.parse_swap_sets(good, B)
    for bad, msg in ((["0-6"], "invalid system index"),
                     (["0-1,1-2"], "Overlapping"), (["3-3"], "Overlapping")):
        for parse in (parse_swap_sets, jrep.parse_swap_sets):
            with pytest.raises(ValueError, match=msg):
                parse(bad, B)


def test_even_odd_swap_sets_match_jax():
    for n in range(1, 9):
        assert even_odd_swap_sets(n) == jrep.even_odd_swap_sets(n)


def _toy(k, xp):
    """Energies of slot i: k_i * sum |x|^2 (its own Hamiltonian)."""
    return lambda p: k * (p * p).sum((-1, -2)) if xp is torch else \
        k * jnp.sum(p * p, axis=(-1, -2))


@pytest.mark.parametrize("hamiltonian", [True, False],
                         ids=["hamiltonian", "slot_independent"])
def test_attempt_swaps_matches_jax(hamiltonian):
    rng = np.random.default_rng(7)
    pos = rng.normal(size=(B, 9, 3)) * rng.uniform(0.6, 1.4, (B, 1, 1))
    k = rng.uniform(0.8, 1.2, B) if hamiltonian else np.full(B, 1.0)
    beta = 1.0 / (0.8 * 1.02 ** np.arange(B))
    cache = {"rotamer": {"nb": rng.normal(size=(B, 4, 6)),
                         "eb": rng.normal(size=(B, 4, 4, 6)),
                         "prev_nb": rng.normal(size=(B, 4, 6)),
                         "dev": rng.normal(size=B),
                         "iters": np.arange(B, dtype=np.int32)}}
    sets = even_odd_swap_sets(B)
    ours, ref = ReplicaExchange(sets, B), jrep.ReplicaExchange(sets, B)
    t = dict(pos=torch.tensor(pos), ridx=torch.arange(B), stats=None,
             aux=jax.tree.map(torch.tensor, cache))
    j = dict(pos=jnp.asarray(pos), ridx=jnp.arange(B), stats=None,
             aux=jax.tree.map(jnp.asarray, cache))
    accepted = rejected = 0
    for r in range(4):
        key = jax.random.PRNGKey(100 + r)
        j["pos"], j["ridx"], j["stats"], e_j, j["aux"] = ref.attempt_swaps(
            key, j["pos"], j["ridx"], jnp.asarray(beta),
            _toy(jnp.asarray(k), jnp), j["stats"],
            slot_independent=not hamiltonian, aux=j["aux"])
        uniforms = []
        for pairs in sets:
            key, sub = jax.random.split(key)
            uniforms.append(torch.tensor(np.asarray(jax.random.uniform(
                sub, (len(pairs),), jnp.float64))))
        t["pos"], t["ridx"], t["stats"], e_t, t["aux"] = ours.attempt_swaps(
            t["pos"], t["ridx"], torch.tensor(beta),
            _toy(torch.tensor(k), torch), t["stats"],
            slot_independent=not hamiltonian, aux=t["aux"],
            uniforms=uniforms)
        np.testing.assert_array_equal(t["pos"].numpy(), np.asarray(j["pos"]))
        np.testing.assert_array_equal(t["ridx"].numpy(),
                                      np.asarray(j["ridx"]))
        np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-12)
        for a, b in zip(t["stats"], j["stats"]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for name, v in t["aux"]["rotamer"].items():
            np.testing.assert_array_equal(
                v.numpy(), np.asarray(j["aux"]["rotamer"][name]))
        last = np.concatenate([s.numpy() for s in t["stats"]])[:, 0]
        accepted, rejected = last.sum(), 4 * len(last) - last.sum()
    assert accepted > 0 and rejected > 0
    # the cache travelled with the configurations
    perm = t["ridx"].numpy()
    np.testing.assert_array_equal(t["aux"]["rotamer"]["iters"].numpy(), perm)
    np.testing.assert_array_equal(t["pos"].numpy(), pos[perm])


def test_hamiltonian_exchange_round_of_the_system_matches_jax():
    records, pos, js, jp, ts = load_pair(TRP)
    n = 4
    P = pos.astype(np.float64) + 0.2 * np.random.default_rng(3).normal(
        size=(n,) + pos.shape)
    port, ref = [], []
    for i in range(n):
        f = 1.0 + 0.3 * (i / (n - 1) - 0.5)
        port.append({**ts.params, "angle_spring": {
            **ts.params["angle_spring"],
            "spring_const": ts.params["angle_spring"]["spring_const"] * f}})
        ref.append({**jp, "angle_spring": {
            **jp["angle_spring"],
            "spring_const": jp["angle_spring"]["spring_const"] * f}})
    mixed, spec = stack_param_ensembles(port)
    jmixed, jspec = jsim.stack_param_ensembles(ref)
    axes = jsim.param_axes(jmixed, jspec)
    beta = 1.0 / np.array([0.6, 0.9, 1.3, 1.8])
    sets = even_odd_swap_sets(n)
    key = jax.random.PRNGKey(4)
    energy_j = jax.jit(jax.vmap(js.energy, in_axes=(0, axes)))
    pos_j, ridx_j, stats_j, e_j = jrep.ReplicaExchange(sets, n).attempt_swaps(
        key, jnp.asarray(P), jnp.arange(n), jnp.asarray(beta),
        lambda p: energy_j(p, jmixed))
    uniforms = []
    for pairs in sets:
        key, sub = jax.random.split(key)
        uniforms.append(torch.tensor(np.asarray(jax.random.uniform(
            sub, (len(pairs),), jnp.float64))))
    sim = Simulation(ts)
    pos_t, ridx_t, stats_t, e_t, _ = ReplicaExchange(sets, n).attempt_swaps(
        torch.tensor(P), torch.arange(n), torch.tensor(beta),
        sim.energy_fn(mixed), uniforms=uniforms)
    np.testing.assert_array_equal(ridx_t.numpy(), np.asarray(ridx_j))
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-5)
    for a, b in zip(stats_t, stats_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the carried energies are each slot's energy of what it now holds
    np.testing.assert_allclose(e_t.numpy(),
                               sim.energy_fn(mixed)(pos_t).numpy(),
                               rtol=1e-12)


def _cli_stops(n_round, frame_rounds, replica_interval):
    """The rounds at which the command line's loop stops, and which of
    them are frames and exchanges (upside_md_tpu/cli.py:253-263, 336)."""
    out, done = [], 0
    while done < n_round:
        target = min(done + frame_rounds, n_round)
        if replica_interval:
            next_rep = ((done // replica_interval) + 1) * replica_interval
            target = min(target, next_rep)
        done = target
        out.append((done, done % frame_rounds == 0 or done == n_round,
                    bool(replica_interval) and done % replica_interval == 0))
    return out


@pytest.mark.parametrize("n_round, frames, rex", [
    (60, 10, 10), (60, 10, 0), (37, 10, 4), (25, 6, 10), (9, 20, 3)])
def test_event_rounds_match_the_command_line(n_round, frames, rex):
    got = event_rounds(0, n_round, frames, rex)
    assert got == _cli_stops(n_round, frames, rex)
    # every exchange round of the command line's schedule is one
    events = sorted({n_round} | (set(range(rex, n_round + 1, rex))
                                 if rex else set()))
    assert {r for r, _, x in got if x} == \
        {r for r in events if rex and r % rex == 0}


def test_run_ensemble_on_the_cpu():
    """A short Hamiltonian exchange run of trp-cage: frames every 2 rounds
    with recentering, exchange every 2, pivot-free.  The carried energies
    equal a fresh evaluation, replica_index is a permutation, the frame
    values have their shapes."""
    records, pos, _, _, ts = load_pair(TRP)
    n = 3
    port = []
    for i in range(n):
        port.append({**ts.params, "angle_spring": {
            **ts.params["angle_spring"],
            "spring_const": ts.params["angle_spring"]["spring_const"]
            * (1.0 + 0.02 * (i - 1))}})
    mixed, spec = stack_param_ensembles(port)
    sim = Simulation(ts, dt=0.009, thermostat_interval=0.135,
                     frame_interval=0.054, seed=2)
    state = sim.initial_state(pos, n, 0.8 * 1.02 ** np.arange(n))
    frames = []
    state, out = run_ensemble(
        sim, state, mixed, spec, 4, ReplicaExchange(even_odd_swap_sets(n), n),
        2, frame_callback=lambda r, v: frames.append((r, v)))
    assert [r for r, _ in frames] == [2, 4] and state.round_num == 4
    assert sorted(out["replica_index"].tolist()) == list(range(n))
    np.testing.assert_allclose(out["energies"].numpy(),
                               sim.potential_energy(state, mixed).numpy(),
                               rtol=1e-12)
    assert out["n_energy_evals"] == 2 * (1 + 2) + 2
    v = frames[-1][1]
    assert v["potential"].shape == (n,) and v["kinetic"].shape == (n,)
    assert v["rotamer_solve_iters"].shape == (n,)
    assert np.abs(state.pos.mean(1).numpy()).max() < 1e-9
    assert torch.isfinite(state.mom).all()


def test_simulation_run_frames_and_recenters():
    """`Simulation.run` (sim.py:327-343): chunks of frame_interval rounds,
    each followed by recentering and the callback, the last chunk cut at
    n_round."""
    records, pos, _, _, ts = load_pair(TRP)
    sim = Simulation(ts, dt=0.009, frame_interval=0.054, seed=1)
    seen = []
    state = sim.run(sim.initial_state(pos, 1), n_round=3,
                    frame_callback=lambda st: seen.append(
                        (st.round_num, st.pos.mean(1).abs().max().item())))
    assert [r for r, _ in seen] == [2, 3] and state.round_num == 3
    assert max(c for _, c in seen) < 1e-9
