"""The port's replica sharding (`upside_md_torch/parallel/mesh.py`) on Gloo
ranks of the CPU, against the JAX package's `parallel/mesh.py` on its
8-device virtual mesh and against the port's own unsharded loop.

Ranks are processes spawned with `torch.multiprocessing.spawn`, joined
through `init_method="file://<tmp>"`; each writes its results for the test
process to read.  float64 throughout.

* The harmonic `atom_pos_spring` system of tests/test_parallel.py: 8
  replicas over 4 ranks, 20 rounds, fed the JAX package's thermostat draws
  (as tests/test_torch_ensemble.py feeds them), against JAX
  `sharded_advance` (atol 1e-5); no collective inside the advance; B not
  divisible by W raises; a 16-position batch's training-step gradient
  against JAX `sharded_training_step`'s (atol 1e-4).
* trp-cage (`trp_cage_full_synth.npz`), 8 slots over 2 ranks: a
  Hamiltonian spring ladder for 3 rounds with a pivot move at round 2 and
  one sharded exchange with the warm-start cache, against the port's
  unsharded advance and `attempt_swaps` (positions rel 1e-6; pivot stats,
  replica_index, swap stats and cache equal).
* The dry run's command on 2 CPU ranks.
* On a card only (`requires_cuda`): a kernel launched on cuda:1 while the
  current device is cuda:0, and a 2-rank NCCL advance.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from helpers import spec
from upside_md_torch import DATA_DIR
from upside_md_torch.config import bundle
from upside_md_torch.convert import from_jax_specs
from upside_md_torch.parallel import dryrun
from upside_md_torch.parallel import mesh as M
from upside_md_torch.system import System
from upside_md_tpu import build_system
from upside_md_tpu.md.sim import Simulation as JSimulation
from upside_md_tpu.md.thermostat import THERMOSTAT_STREAM, stream_key
from upside_md_tpu.parallel.mesh import make_replica_mesh as jax_mesh
from upside_md_tpu.parallel.mesh import sharded_advance as jax_advance
from upside_md_tpu.parallel.mesh import \
    sharded_training_step as jax_training_step

TRP = os.path.join(DATA_DIR, "trp_cage_full_synth.npz")
N_ATOM, N_REP, ROUNDS, SEED = 5, 8, 20, 0
DT, THERMO = 0.01, 0.09          # a thermostat step every 3 rounds
TRAIN_ATOM, TRAIN_BATCH, LR = 4, 16, 0.01
LADDER_SLOTS, LADDER_ROUNDS = 8, 3


def harmonic_specs(n_atom, k=3.0):
    return [spec("atom_pos_spring", ["pos"],
                 {"id": np.arange(n_atom, dtype=np.int32)},
                 {"x0": np.zeros((n_atom, 3)),
                  "spring_const": np.full(n_atom, k)})]


def port_system(specs, n_atom):
    records, _ = from_jax_specs(specs, np.zeros((n_atom, 3)))
    return System(n_atom, records, device="cpu", dtype=torch.float64)


def spawn(fn, ranks, tmp_path, *args):
    """Run fn(rank, mesh, out_dir, *args) on `ranks` Gloo ranks of the CPU;
    returns each rank's saved result."""
    init = f"file://{tmp_path}/pg"
    mp.spawn(_rank, (fn, ranks, init, str(tmp_path), args), nprocs=ranks)
    return [torch.load(os.path.join(tmp_path, f"rank{r}.pt"),
                       weights_only=False) for r in range(ranks)]


def _rank(rank, fn, ranks, init, out_dir, args):
    torch.set_num_threads(1)
    mesh = M.make_replica_mesh(ranks, rank, "cpu", init_method=init)
    try:
        out = fn(rank, mesh, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        mesh.close()


def sgd(params, grads, opt_state):
    return ({n: {k: v - LR * grads[n][k] if k in grads.get(n, {}) else v
                 for k, v in g.items()} for n, g in params.items()},
            opt_state)


# ---------------------------------------------------------------------------
# the harmonic system against the JAX mesh
# ---------------------------------------------------------------------------

def harmonic_rank(rank, mesh, pos0, mom0, noise, batch, target):
    from upside_md_torch.md.sim import Simulation
    system = port_system(harmonic_specs(N_ATOM), N_ATOM)
    sim = Simulation(system, dt=DT, thermostat_interval=THERMO,
                     do_recenter=False)
    state = sim.initial_state(pos0, N_REP, 1.0)
    state.mom = torch.tensor(mom0)
    local = M.shard_replica_state(state, mesh)
    M.reset_counts()
    out = M.sharded_advance(sim, mesh, ROUNDS)(
        local, noise=lambda nr: torch.tensor(noise[nr]))
    inside = dict(M.COLLECTIVES)
    whole = M.gather_replica_state(out, mesh)
    res = {"collectives": inside, "local_rows": out.pos.shape[0],
           "round_num": out.round_num, "pos": whole.pos.numpy()}
    try:
        M.shard_replica_state(sim.initial_state(pos0[:6], 6, 1.0), mesh)
        res["indivisible"] = "no error"
    except ValueError as e:
        res["indivisible"] = str(e)

    tsys = port_system(harmonic_specs(TRAIN_ATOM), TRAIN_ATOM)
    step = M.sharded_training_step(tsys, sgd, mesh)
    new, _, loss = step(tsys.params, (), torch.tensor(batch),
                        torch.tensor(target))
    res["loss"] = loss.item()
    res["grad"] = {n: {k: ((tsys.params[n][k] - v) / LR).numpy()
                       for k, v in g.items() if v.is_floating_point()}
                   for n, g in new.items()}
    return res


@pytest.fixture(scope="module")
def harmonic(tmp_path_factory):
    """The JAX mesh's sharded advance and training step, and the port's on
    4 Gloo ranks, from the same inputs and thermostat draws."""
    rng = np.random.default_rng(0)
    jsys = build_system(N_ATOM, harmonic_specs(N_ATOM))
    jsim = JSimulation(jsys, dt=DT, thermostat_interval=THERMO,
                       do_recenter=False)
    jparams = jsys.make_params()
    pos0 = 0.2 * rng.normal(size=(N_ATOM, 3))
    jstate = jsim.initial_state(pos0, jparams, seed=SEED, temperature=1.0,
                                n_replica=N_REP)
    jout = jax_advance(jsim, jax_mesh(8), ROUNDS)(jstate, jparams)
    noise = {nr: np.stack([np.asarray(jax.random.normal(
        stream_key(SEED + i, THERMOSTAT_STREAM, nr + 1), (N_ATOM, 3),
        jnp.float64)) for i in range(N_REP)])
        for nr in range(0, ROUNDS, jsim.thermostat_interval)}

    tsys = build_system(TRAIN_ATOM, harmonic_specs(TRAIN_ATOM))
    tparams = tsys.make_params()
    batch = rng.normal(size=(TRAIN_BATCH, TRAIN_ATOM, 3))
    target = rng.normal(size=(TRAIN_BATCH,)) ** 2

    def jsgd(params, grads, opt_state):
        return (jax.tree.map(lambda p, g: p - LR * g, params, grads),
                opt_state)

    new, _, loss = jax_training_step(tsys, jsgd, jax_mesh(8))(
        tparams, (), jnp.asarray(batch), jnp.asarray(target))
    jgrad = jax.tree.map(lambda a, b: (np.asarray(a) - np.asarray(b)) / LR,
                         tparams, new)
    ranks = spawn(harmonic_rank, 4, tmp_path_factory.mktemp("harmonic"),
                  np.broadcast_to(pos0, (N_REP, N_ATOM, 3)).copy(),
                  np.asarray(jstate.mom), noise, batch, target)
    return dict(jpos=np.asarray(jout.pos), jround=np.asarray(jout.round_num),
                jloss=float(loss), jgrad=jgrad, ranks=ranks)


def test_sharded_advance_matches_jax_mesh(harmonic):
    """8 replicas over 4 ranks, 20 rounds on the JAX thermostat draws: the
    gathered positions equal the JAX mesh's sharded advance (atol 1e-5, as
    tests/test_parallel.py holds that one to the unsharded run)."""
    assert np.all(harmonic["jround"] == ROUNDS)
    for r in harmonic["ranks"]:
        assert r["round_num"] == ROUNDS and r["local_rows"] == N_REP // 4
        np.testing.assert_allclose(r["pos"], harmonic["jpos"], rtol=0,
                                   atol=1e-5)


def test_sharded_advance_issues_no_collective(harmonic):
    """Between exchange rounds the ranks share nothing: no collective is
    counted inside the advance on any rank."""
    for r in harmonic["ranks"]:
        assert r["collectives"] == {"all_gather": 0, "all_reduce": 0,
                                    "barrier": 0}


def test_shard_requires_divisible_replicas(harmonic):
    """6 replicas do not divide over 4 ranks: shard_replica_state raises, as
    the JAX mesh refuses the placement."""
    for r in harmonic["ranks"]:
        assert "do not divide over 4 ranks" in r["indivisible"]


def test_training_step_gradient_matches_jax(harmonic):
    """A 16-position batch over 4 ranks: the all_reduce'd gradient (read
    back from one SGD step, as tests/test_parallel.py reads the JAX one)
    and loss equal JAX `sharded_training_step`'s (atol 1e-4)."""
    for r in harmonic["ranks"]:
        assert r["loss"] == pytest.approx(harmonic["jloss"], rel=1e-12)
        for n, leaves in harmonic["jgrad"].items():
            for k, g in leaves.items():
                np.testing.assert_allclose(r["grad"][n][k], np.asarray(g),
                                           rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# trp-cage: a Hamiltonian ladder and an exchange against the unsharded loop
# ---------------------------------------------------------------------------

def ladder(system, n):
    from upside_md_torch.md.sim import stack_param_ensembles
    k = system.params["angle_spring"]["spring_const"]
    return stack_param_ensembles([
        {**system.params, "angle_spring": {
            **system.params["angle_spring"],
            "spring_const": k * (1.0 + 0.01 * i)}} for i in range(n)])


def ladder_rank(rank, mesh):
    from test_torch_mc import pivot_tables
    from upside_md_torch.md.mc import PivotSampler
    from upside_md_torch.md.replica import (ReplicaExchange,
                                            even_odd_swap_sets)
    from upside_md_torch.md.sim import Simulation
    system, pos = System.from_bundle(TRP, device="cpu", dtype=torch.float64)
    pivot = PivotSampler.from_tables(
        *pivot_tables(bundle.load(TRP)[0], len(pos), seed=5), device="cpu")
    mixed, spec_ = ladder(system, LADDER_SLOTS)
    temps = 0.8 * 1.02 ** np.arange(LADDER_SLOTS)
    beta = torch.tensor(1.0 / temps)
    rex = ReplicaExchange(even_odd_swap_sets(LADDER_SLOTS), LADDER_SLOTS)
    idx0 = torch.arange(LADDER_SLOTS)

    def new_sim():
        # a thermostat step every round, a pivot move at round 2
        return Simulation(system, dt=0.009, thermostat_interval=0.027,
                          mc_interval=0.054, pivot_sampler=pivot,
                          do_recenter=False, seed=5)

    sim = new_sim()
    state = M.shard_replica_state(
        sim.initial_state(pos, LADDER_SLOTS, temps), mesh)
    advance, local = M.sharded_hamiltonian_advance(
        sim, mesh, LADDER_ROUNDS, mixed, spec_)
    M.reset_counts()
    state = advance(state)
    in_advance = sum(M.COLLECTIVES.values())
    state, idx, stats, energies = M.sharded_attempt_swaps(
        mesh, rex, state, idx0, beta, sim.energy_fn(local),
        generator=sim.generator)
    whole = M.gather_replica_state(state, mesh)
    out = {"collectives": in_advance, "pos": whole.pos,
           "pivot_stats": whole.pivot_stats,
           "cache": whole.cache, "index": idx, "stats": stats,
           "energies": energies,
           "local_slots": local["angle_spring"]["spring_const"].shape[0]}
    if rank == 0:
        ref = new_sim()
        st = ref.advance(ref.initial_state(pos, LADDER_SLOTS, temps),
                         LADDER_ROUNDS, mixed, spec_)
        out["ref_pivot_stats"] = st.pivot_stats
        (out["ref_pos"], out["ref_index"], out["ref_stats"],
         out["ref_energies"], out["ref_cache"]) = rex.attempt_swaps(
            st.pos, idx0, beta, ref.energy_fn(mixed), aux=st.cache,
            generator=ref.generator)
    return out


@pytest.fixture(scope="module")
def trp_ladder(tmp_path_factory):
    return spawn(ladder_rank, 2, tmp_path_factory.mktemp("ladder"))


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def test_sharded_hamiltonian_exchange_matches_unsharded(trp_ladder):
    """trp-cage, 8 slots of a spring ladder over 2 ranks: 3 sharded rounds
    (a pivot move at round 2, its draws the whole ensemble's) and one
    exchange across the ranks give the unsharded advance's and
    `attempt_swaps`' positions (rel 1e-6), pivot stats, replica_index,
    swap stats and carried energies, and the warm-start cache moved with
    the configurations (equal)."""
    r0 = trp_ladder[0]
    assert r0["local_slots"] == LADDER_SLOTS // 2
    assert torch.equal(r0["pivot_stats"], r0["ref_pivot_stats"])
    assert r0["pivot_stats"][:, 1].tolist() == [1] * LADDER_SLOTS
    assert 0 < r0["pivot_stats"][:, 0].sum() < LADDER_SLOTS
    assert _rel(r0["pos"], r0["ref_pos"]) < 1e-6
    assert torch.equal(r0["index"], r0["ref_index"])
    assert r0["index"].tolist() != list(range(LADDER_SLOTS))
    for got, want in zip(r0["stats"], r0["ref_stats"]):
        assert torch.equal(got, want)
    assert _rel(r0["energies"], r0["ref_energies"]) < 1e-6
    for node, entries in r0["ref_cache"].items():
        for k, want in entries.items():
            assert torch.equal(r0["cache"][node][k], want), (node, k)
    for r in trp_ladder:
        assert r["collectives"] == 0
        assert torch.equal(r["index"], r0["index"])


# ---------------------------------------------------------------------------
# the dry run's command line, and the card-only cases
# ---------------------------------------------------------------------------

def test_dryrun_command_on_cpu_ranks(capsys):
    """`python -m upside_md_torch.parallel.dryrun --ranks 2 --device cpu`:
    the five steps on the full ubiquitin force field, 4 replicas; every
    rank's audit finds no collective inside either advance."""
    assert dryrun.main(["--ranks", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "dry run ok: 2 ranks, 4 replicas, gloo on cpu" in out


@pytest.mark.requires_cuda
def test_launch_follows_the_operands_device():
    """K2 and K1 on cuda:1 while the current device is cuda:0 launch on
    cuda:1 and equal their plain versions there; operands on two devices
    raise.  Needs two cards: it skips on a one-card machine and without
    one."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from upside_md_torch.ops import kernels
    system, pos = System.from_bundle(TRP, device="cuda:1")
    plain, _ = System.from_bundle(TRP, device="cuda:1", kernels=False)
    torch.cuda.set_device(0)
    x = pos.expand(4, -1, -1).contiguous()
    kernels.reset_counts()
    g, e, _ = system.deriv(x, system.init_cache(4))
    torch.cuda.synchronize(1)
    assert kernels.LAUNCHES["fused_pair_fwd"] == 1
    assert kernels.LAUNCHES["bp_bethe_pairs"] == 1
    assert g.device == torch.device("cuda", 1)
    gp, ep, _ = plain.deriv(x, plain.init_cache(4))
    assert _rel(e, ep) < 1e-3 and _rel(g, gp) < 1e-3
    with pytest.raises(ValueError, match="expected one CUDA device"):
        kernels.launch("fused_pair_fwd", x, x.to("cuda:0"))


@pytest.mark.requires_cuda
def test_nccl_advance_on_two_cards():
    """The dry run over NCCL on two cards, one rank a card.  Needs two
    cards: it skips on a one-card machine and without one."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    results = dryrun.run(2, "cuda", "nccl")
    assert [r["device"] for r in results] == ["cuda:0", "cuda:1"]
    for r in results:
        assert all(a["collectives"] == 0 and not a["comm_events"]
                   for a in r["audit"])
        assert r["launches"]["fused_pair_fwd"] > 0
