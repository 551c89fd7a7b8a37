"""Plain replica MD rounds (reference src/main.cpp:616-673,
deriv_engine.cpp:11-48, thermostat.cpp), for the benchmark's reference.

A round is an Ornstein-Uhlenbeck thermostat step, when the round number is
a multiple of the thermostat's interval,

    p <- s p + sqrt(T (1 - s^2)) xi,   s = exp(-interval time / timescale),

and then three stages of the Verlet cycle with unit masses: at each stage
p <- p - dt dU/dx, then x <- x + dt p (the cycle's stage weights are all 1
for Verlet).  The thermostat's noise xi of each round is handed in.
"""

from __future__ import annotations

import math


def follow(ff, pos, mom, first_round, n_rounds, dt, every, timescale,
           temperature, noise, dtype=None):
    """(pos, mom) after n_rounds rounds from round `first_round`, the
    state kept in `dtype` (the force field's by default), the forces in
    the force field's; noise(nr) gives round nr's noise of these
    replicas."""
    dtype = dtype or ff.dtype
    pos, mom = pos.to(dtype), mom.to(dtype)
    s = math.exp(-every * 3.0 * dt / timescale)
    for nr in range(first_round, first_round + n_rounds):
        if nr % every == 0:
            mom = s * mom + math.sqrt(temperature * (1.0 - s * s)) \
                * noise(nr).to(dtype)
        for _ in range(3):
            mom = mom - dt * ff.gradient(pos).to(dtype)
            pos = pos + dt * mom
    return pos, mom
