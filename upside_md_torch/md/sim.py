"""Simulation loop over a replica batch (port of upside_md_tpu/md/sim.py;
reference main loop src/main.cpp:616-673).

One round is: Monte Carlo moves (every `mc_interval` rounds, never at
round 0), an OU thermostat step at the annealed temperature (every
`thermostat_interval` rounds), then a 3-stage integration cycle with
optional force clipping.  The round counter is global across replicas.
Nothing in a round reads a value back from the card: MC acceptance,
statistics and temperatures stay tensors.

A Hamiltonian ensemble gives every replica slot its own parameters
(`stack_param_ensembles`); `System.evaluate` evaluates each slot under
its own.  Random draws come from one `torch.Generator` per Simulation, on
the system's device (bitwise parity with the JAX package's counter-based
streams is not a goal); each draw can also be handed in, as the parity
tests hand in JAX's.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional

import numpy as np
import torch

from .integrator import integration_cycle, recenter
from .mc import JumpSampler, PivotSampler, metropolis_step
from .thermostat import OUThermostat, thermalize


def _equal(a, b):
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return torch.equal(a, b)
    return np.array_equal(np.asarray(a), np.asarray(b))


def stack_param_ensembles(param_list):
    """Combine per-slot parameter sets {node: {name: tensor}} into one for
    a Hamiltonian ensemble (sim.py:30-66 of the JAX package).

    Only the leaves that differ across slots are stacked along a new
    leading replica axis; identical leaves stay shared, so the kernels
    whose tables are shared keep their one launch over all replicas.
    Returns (params, spec): spec is the frozenset of stacked (node, name)
    leaves."""
    first = param_list[0]
    shape = {n: sorted(leaves) for n, leaves in first.items()}
    for i, p in enumerate(param_list[1:], 1):
        if {n: sorted(leaves) for n, leaves in p.items()} != shape:
            raise ValueError(
                f"Hamiltonian ensemble slot {i} has a different parameter "
                f"structure than slot 0: every config must define the "
                f"same potentials")
    spec = frozenset(
        (n, k) for n, leaves in first.items() for k, v in leaves.items()
        if not all(_equal(v, p[n][k]) for p in param_list[1:]))
    combined = {n: {k: torch.stack([p[n][k] for p in param_list])
                    if (n, k) in spec else v for k, v in leaves.items()}
                for n, leaves in first.items()}
    return combined, spec


def param_axes(params, spec):
    """The replica axis of each leaf of `params` combined by
    `stack_param_ensembles` (the vmap in_axes of sim.py:68-79): 0 at
    stacked leaves, None at shared ones.  spec=True means fully stacked
    (0), False or empty fully shared (None)."""
    if spec is True:
        return 0
    if not spec:
        return None
    return {n: {k: 0 if (n, k) in spec else None for k in leaves}
            for n, leaves in params.items()}


@dataclass
class SimState:
    pos: torch.Tensor            # (B, n_atom, 3)
    mom: torch.Tensor
    round_num: int               # global round counter
    temperature: torch.Tensor    # (B,)
    initial_temperature: torch.Tensor = None   # (B,) annealing start
    pivot_stats: torch.Tensor = None   # (B, 2) int32 [success, attempt]
    jump_stats: torch.Tensor = None
    cache: Dict = field(default_factory=dict)   # per-node solver state
    bp_sweeps: torch.Tensor = None   # (B,) BP sweeps summed over evals
    n_evals: int = 0


class Simulation:
    def __init__(self, system, dt=0.009, duration=None,
                 thermostat_timescale=5.0, thermostat_interval=None,
                 frame_interval=None, mc_interval=None, integrator="verlet",
                 max_force=0.0, pivot_sampler: Optional[PivotSampler] = None,
                 jump_sampler: Optional[JumpSampler] = None,
                 anneal_factor=1.0, anneal_duration=None, do_recenter=True,
                 xy_recenter_only=False, seed=0):
        """Intervals are in simulation time and become whole rounds of
        3*dt, as the reference CLI does (main.cpp:397-411)."""
        self.system = system
        self.dt = float(dt)
        round_time = 3.0 * self.dt
        self.n_round = int(round(duration / round_time)) if duration else 0
        self.thermostat_interval = max(
            1, int(round((thermostat_interval or round_time) / round_time)))
        self.frame_interval = max(
            1, int(round((frame_interval or round_time) / round_time)))
        self.mc_interval = (max(1, int(mc_interval / round_time))
                            if mc_interval else 0)
        self.integrator = integrator
        self.max_force = max_force
        self.pivot_sampler = pivot_sampler
        self.jump_sampler = jump_sampler
        self.thermostat = OUThermostat(
            thermostat_timescale, self.thermostat_interval * round_time)
        self.anneal_factor = float(anneal_factor)
        self.duration = duration or 0.0
        self.anneal_duration = anneal_duration or self.duration
        self.do_recenter = do_recenter
        self.xy_recenter_only = xy_recenter_only
        self.generator = torch.Generator(device=system.device)
        self.generator.manual_seed(seed)

    def initial_state(self, pos, n_replica, temperature=1.0):
        """Positions (n_atom, 3), copied to every replica, or (B, n_atom,
        3); temperature a scalar or one per replica (sim.py:132-164)."""
        pos = torch.as_tensor(pos, dtype=self.system.dtype,
                              device=self.system.device)
        if pos.ndim == 2:
            pos = pos.expand(n_replica, -1, -1).clone()
        B = pos.shape[0]
        temps = torch.as_tensor(temperature, dtype=pos.dtype,
                                device=pos.device).reshape(-1).expand(B)
        temps = temps.clone()
        mom = thermalize(pos.shape, temps, self.generator, pos.dtype,
                         pos.device)
        stats = torch.zeros((B, 2), dtype=torch.int32, device=pos.device)
        return SimState(pos=pos, mom=mom, round_num=0, temperature=temps,
                        initial_temperature=temps, pivot_stats=stats,
                        jump_stats=stats.clone(),
                        cache=self.system.init_cache(B),
                        bp_sweeps=torch.zeros(B, device=pos.device))

    def _anneal_temperature(self, t0, round_num):
        """sqrt-T-space annealing schedule (main.cpp:437-443)."""
        if self.anneal_factor == 1.0:
            return t0
        time = 3.0 * self.dt * (round_num + 1.0)
        anneal_start = self.duration - self.anneal_duration
        frac = min(max((time - anneal_start)
                       / max(self.anneal_duration, 1e-10), 0.0), 1.0)
        s = t0.sqrt() * (1.0 - frac) + (t0 * self.anneal_factor).sqrt() * frac
        return s * s

    def energy_fn(self, params, n_deriv_evals=0):
        """Cold-started energies (B,) of positions under `params`: what MC
        moves and replica swaps compare (JAX `system.energy(p, params)`,
        whose AFM tip sits at the counter 0 as here)."""
        def energy(p):
            with torch.no_grad():
                return self.system.energy(p, params, n_deriv_evals)
        return energy

    def advance(self, state: SimState, n_rounds: int, params=None,
                spec=None, noise=None, mc_draws=None):
        """Run n_rounds rounds.  params: the system's own by default, or a
        set from `stack_param_ensembles` (spec, if given, must be its
        spec).  noise: optional callable round -> (B, n_atom, 3)
        thermostat noise; mc_draws: optional callable (round, "pivot" or
        "jump") -> that move's draws (`metropolis_step`); otherwise the
        generator draws them."""
        system = self.system
        params = system.params if params is None else params
        if spec is not None and frozenset(spec) != \
                system.stacked_leaves(params):
            raise ValueError("spec does not name the stacked leaves of "
                             "params")
        fused_prep = system.fused_prepared(params)
        energy = self.energy_fn(params)
        pos, mom, cache = state.pos, state.mom, state.cache
        temp = state.temperature
        stats = {"pivot": state.pivot_stats, "jump": state.jump_stats}
        samplers = {"pivot": self.pivot_sampler, "jump": self.jump_sampler}
        sweeps, n_evals = state.bp_sweeps, state.n_evals

        def deriv(p, stage, c):
            # the JAX loop's counter, 3 * round + stage + 1 (sim.py:193)
            nonlocal sweeps, n_evals
            g, _, c = system.deriv(p, c, fused_prep, params,
                                   n_deriv_evals=3 * nr + stage + 1)
            for entry in c.values():
                if isinstance(entry, dict) and "iters" in entry:
                    sweeps = sweeps + entry["iters"]
            n_evals += 1
            return g, c

        for i in range(n_rounds):
            nr = state.round_num + i
            if self.mc_interval and nr > 0 and nr % self.mc_interval == 0:
                for kind, sampler in samplers.items():
                    if sampler is None:
                        continue
                    pos, acc = metropolis_step(
                        pos, temp, energy, sampler, self.generator,
                        None if mc_draws is None else mc_draws(nr, kind))
                    stats[kind] = stats[kind] + torch.stack(
                        [acc.to(torch.int32), torch.ones_like(
                            acc, dtype=torch.int32)], -1)
            if nr % self.thermostat_interval == 0:
                temp = self._anneal_temperature(state.initial_temperature,
                                                nr)
                mom = self.thermostat.apply(
                    mom, temp, self.generator,
                    None if noise is None else noise(nr))
            pos, mom, cache = integration_cycle(
                deriv, pos, mom, self.dt, cache, self.max_force,
                self.integrator)
        return replace(state, pos=pos, mom=mom,
                       round_num=state.round_num + n_rounds,
                       temperature=temp, pivot_stats=stats["pivot"],
                       jump_stats=stats["jump"], cache=cache,
                       bp_sweeps=sweeps, n_evals=n_evals)

    # -- observables --------------------------------------------------------

    def kinetic_energy(self, state):
        """(1/2)<|p|^2> per atom (main.cpp:532-536), (B,)."""
        return 0.5 * state.mom.pow(2).sum(-1).mean(-1)

    def potential_energy(self, state, params=None, n_deriv_evals=0):
        """Each slot's cold-started potential under its own parameters, at
        the force-evaluation counter `n_deriv_evals`."""
        return self.energy_fn(params, n_deriv_evals)(state.pos)

    def recentered(self, state):
        return replace(state, pos=recenter(state.pos, self.xy_recenter_only))

    def run(self, state, params=None, n_round=None, frame_callback=None):
        """Frame-chunked main loop (sim.py:308-343): frame_interval rounds a
        chunk, recentering (if on) and `frame_callback(state)` between."""
        n_round = self.n_round if n_round is None else n_round
        while state.round_num < n_round:
            chunk = min(self.frame_interval, n_round - state.round_num)
            state = self.advance(state, chunk, params)
            if self.do_recenter:
                state = self.recentered(state)
            if frame_callback is not None:
                frame_callback(state)
        return state
