"""Simulation loop over a replica batch (port of the main path of
upside_md_tpu/md/sim.py; reference main loop src/main.cpp:616-673).

One round is an OU thermostat step (every `thermostat_interval` rounds)
followed by a 3-stage Verlet cycle.  The round counter is global across
replicas.  MC moves, annealing, Hamiltonian ensembles and recentering are
not part of this slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict

import torch

from .integrator import integration_cycle
from .thermostat import OUThermostat, thermalize


@dataclass
class SimState:
    pos: torch.Tensor            # (B, n_atom, 3)
    mom: torch.Tensor
    round_num: int               # global round counter
    temperature: torch.Tensor    # (B,)
    cache: Dict = field(default_factory=dict)   # per-node solver state
    bp_sweeps: torch.Tensor = None   # (B,) BP sweeps summed over evals
    n_evals: int = 0


class Simulation:
    def __init__(self, system, dt=0.009, thermostat_timescale=5.0,
                 thermostat_interval=None, seed=0):
        """Intervals are in simulation time and become whole rounds of
        3*dt, as the reference CLI does (main.cpp:397-411)."""
        self.system = system
        self.dt = float(dt)
        round_time = 3.0 * self.dt
        self.thermostat_interval = max(
            1, int(round((thermostat_interval or round_time) / round_time)))
        self.thermostat = OUThermostat(
            thermostat_timescale, self.thermostat_interval * round_time)
        self.generator = torch.Generator(device=system.device)
        self.generator.manual_seed(seed)

    def initial_state(self, pos, n_replica, temperature=1.0):
        pos = torch.as_tensor(pos, dtype=self.system.dtype,
                              device=self.system.device)
        if pos.ndim == 2:
            pos = pos.expand(n_replica, -1, -1).clone()
        temps = torch.full((pos.shape[0],), float(temperature),
                           dtype=pos.dtype, device=pos.device)
        mom = thermalize(pos.shape, temps, self.generator, pos.dtype,
                         pos.device)
        return SimState(pos=pos, mom=mom, round_num=0, temperature=temps,
                        cache=self.system.init_cache(pos.shape[0]),
                        bp_sweeps=torch.zeros(pos.shape[0],
                                              device=pos.device))

    def advance(self, state: SimState, n_rounds: int, noise=None):
        """Run n_rounds rounds.  noise: optional callable round -> (B,
        n_atom, 3) thermostat noise (for tests); otherwise the generator."""
        system = self.system
        fused_prep = system.fused_prepared()
        pos, mom, cache = state.pos, state.mom, state.cache
        sweeps, n_evals = state.bp_sweeps, state.n_evals

        def deriv(p, stage, c):
            nonlocal sweeps, n_evals
            g, _, c = system.deriv(p, c, fused_prep)
            for entry in c.values():
                if isinstance(entry, dict) and "iters" in entry:
                    sweeps = sweeps + entry["iters"]
            n_evals += 1
            return g, c

        for i in range(n_rounds):
            nr = state.round_num + i
            if nr % self.thermostat_interval == 0:
                mom = self.thermostat.apply(
                    mom, state.temperature, self.generator,
                    None if noise is None else noise(nr))
            pos, mom, cache = integration_cycle(deriv, pos, mom, self.dt,
                                                cache)
        return replace(state, pos=pos, mom=mom,
                       round_num=state.round_num + n_rounds, cache=cache,
                       bp_sweeps=sweeps, n_evals=n_evals)
