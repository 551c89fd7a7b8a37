"""The run loop of the JAX package's command line (upside_md_tpu/cli.py:
236-370) as a library function, `run_ensemble`.

It advances a replica ensemble to each frame or exchange round, recentres
and hands the frame's values to a callback at frames, and attempts replica
exchange at exchange rounds, each slot keeping its own Hamiltonian.  The
command line's argument parsing, its HDF5 logger (`H5Logger`) and its
signal handling are not ported yet: they belong to the io slice, and the
machine with the card has no h5py.  A caller writes what the logger would
from the frames `frame_callback` receives.
"""

from __future__ import annotations

import time
from dataclasses import replace

import numpy as np
import torch


def event_rounds(start, n_round, frame_interval, replica_interval=0):
    """The rounds at which the loop stops, as (round, is_frame,
    is_exchange), from `start` up to `n_round` (cli.py:253-263)."""
    events, done = [], start
    while done < n_round:
        target = min(done + frame_interval, n_round)
        if replica_interval:
            target = min(target, (done // replica_interval + 1)
                         * replica_interval)
        done = target
        events.append((done, done % frame_interval == 0 or done == n_round,
                       bool(replica_interval)
                       and done % replica_interval == 0))
    return events


def _frame(sim, state, params, replica_index, last_mc, done):
    """One frame's values as numpy arrays (cli.py:265-327): potential per
    slot at the force-evaluation counter 3 * done (cli.py:269), kinetic
    energy, temperature, replica index, the MC stats since the last frame,
    and each rotamer node's BP health."""
    system = sim.system
    frame = {"potential": sim.potential_energy(state, params, 3 * done),
             "kinetic": sim.kinetic_energy(state),
             "temperature": state.temperature,
             "replica_index": replica_index}
    for kind, sampler in (("pivot", sim.pivot_sampler),
                          ("jump", sim.jump_sampler)):
        if sampler is None:
            continue
        cur = getattr(state, kind + "_stats")
        # per-frame stats with reset semantics (monte_carlo_sampler.h:
        # 28-37)
        frame[kind + "_stats"] = cur - last_mc.get(kind, torch.zeros_like(
            cur))
        last_mc[kind] = cur
    for name, entry in state.cache.items():
        if system.by_name[name].node_type.name != "rotamer":
            continue
        tol = system.by_name[name].consts.get("tol", 1e-3)
        frame[name + "_n_bad_solve"] = (entry["dev"] > tol).to(torch.int32)
        frame[name + "_solve_iters"] = entry["iters"]
    return {k: v.detach().cpu().numpy() for k, v in frame.items()}


def run_ensemble(sim, state, params, spec, n_round, rex=None,
                 replica_interval=0, beta=None, frame_callback=None):
    """Run the ensemble from its round number up to round `n_round`.

    params, spec: the slots' parameters and the stacked leaves
    (`md.sim.stack_param_ensembles`; the system's own and an empty spec
    for one shared Hamiltonian).  rex: a `ReplicaExchange`, attempted
    every `replica_interval` rounds with inverse temperatures `beta` (the
    slots' initial temperatures' by default); with shared parameters the
    swaps only permute the energies (`slot_independent`).  Frames come
    every `sim.frame_interval` rounds and at the end: the state is
    recentred there (if `sim.do_recenter`) and
    `frame_callback(round, values)` receives `_frame`'s values.

    Returns (state, summary): the final `replica_index`, the swap stats
    per pair per set, the energies carried by the last exchange round,
    the energy-only evaluations of the frames and exchanges, the frames'
    kinetic energies and the wall time."""
    hamiltonian = bool(spec)
    B = state.pos.shape[0]
    dev = state.pos.device
    replica_index = torch.arange(B, device=dev)
    if beta is None:
        beta = 1.0 / state.initial_temperature
    energy_of = sim.energy_fn(params)
    rex_stats = energies = None
    n_energy_evals = 0
    last_mc, kinetic = {}, []
    t_start = time.perf_counter()
    start = done = state.round_num
    for target, is_frame, is_exchange in event_rounds(
            start, n_round, sim.frame_interval, replica_interval):
        state = sim.advance(state, target - done, params, spec)
        done = target
        if is_frame:
            if sim.do_recenter:
                state = sim.recentered(state)
            values = _frame(sim, state, params, replica_index, last_mc,
                            done)
            n_energy_evals += 1
            kinetic.append(values["kinetic"])
            if frame_callback is not None:
                frame_callback(done, values)
        if is_exchange and rex is not None:
            # the solver warm-start cache swaps WITH the configurations
            pos, replica_index, rex_stats, energies, cache = \
                rex.attempt_swaps(state.pos, replica_index, beta, energy_of,
                                  rex_stats, slot_independent=not hamiltonian,
                                  aux=state.cache, generator=sim.generator)
            n_energy_evals += 1 + (0 if not hamiltonian
                                   else len(rex.swap_sets))
            state = replace(state, pos=pos, cache=cache)
    if state.pos.is_cuda:
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t_start
    steps = 3 * (done - start)
    print(f"\nfinished in {elapsed:.1f} seconds "
          f"({elapsed * 1e6 / max(B, 1) / max(steps, 1):.2f} "
          f"us/system/step, "
          f"{steps * sim.dt / elapsed * 3600:.1e} "
          f"simulation_time_unit/hour)", flush=True)
    if kinetic:
        # equipartition over the last half of the frames (cli.py:352-360)
        kin = np.stack(kinetic)[len(kinetic) // 2:].mean(0)
        temps = state.initial_temperature.cpu().numpy()
        print("avg_kinetic_energy/1.5kT " + " ".join(
            f"{r: .3f}" for r in kin / (1.5 * temps)), flush=True)
    for kind, sampler in (("pivot", sim.pivot_sampler),
                          ("jump", sim.jump_sampler)):
        if sampler is not None:
            s = getattr(state, kind + "_stats").sum(0).cpu().numpy()
            print(f"{kind}_success: {s[0] / max(s[1], 1):.4f}", flush=True)
    return state, {"replica_index": replica_index, "rex_stats": rex_stats,
                   "energies": energies, "n_energy_evals": n_energy_evals,
                   "kinetic": kinetic, "seconds": elapsed}
