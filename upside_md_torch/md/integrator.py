"""Velocity-Verlet integration round (port of the main path of
upside_md_tpu/md/integrator.py; reference src/deriv_engine.cpp:11-35,
172-192).  One round is three force evaluations; with Verlet weights
(a = 1/6, b = 1/3) every stage's momentum and position weight is 1, and
masses are unit."""

from __future__ import annotations


def integration_cycle(deriv_fn, pos, mom, dt, cache):
    """Advance one round.  deriv_fn(pos, stage, cache) returns (dU/dpos,
    new cache); per stage mom -= dt*deriv, pos += dt*mom.  The solver cache
    threads through the stages, so BP warm-starts from the previous
    stage's solution."""
    for stage in range(3):
        d, cache = deriv_fn(pos, stage, cache)
        mom = mom - dt * d
        pos = pos + dt * mom
    return pos, mom, cache
