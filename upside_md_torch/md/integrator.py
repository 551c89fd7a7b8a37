"""Velocity-Verlet-family integration round (port of
upside_md_tpu/md/integrator.py; reference src/deriv_engine.cpp:11-48,
172-192).  One round is three force evaluations with per-stage momentum
and position weights: `verlet` weights are all 1, `predescu` uses the
optimised coefficients of Predescu et al., 2012.  Masses are unit."""

from __future__ import annotations

import math

INTEGRATOR_COEFFS = {}
for _name, (_a, _b) in {"verlet": (1.0 / 6.0, 1.0 / 3.0),
                        "predescu": (0.108991425403425322,
                                     0.290485609075128726)}.items():
    # (momentum weights, position weights) of the three stages
    INTEGRATOR_COEFFS[_name] = (
        (1.5 - 3 * _a, 1.5 - 3 * _a, 6 * _a),
        (3 * _b, 3.0 - 6 * _b, 3 * _b),
    )


def clip_force(deriv, max_force):
    """Smooth atan clipping of each atom's force to below `max_force`
    (deriv_engine.cpp:25-29); 0 leaves the forces as they are."""
    if not max_force:
        return deriv
    f_mag = deriv.pow(2).sum(-1, keepdim=True).sqrt() + 1e-6
    scale = (f_mag * (0.5 * math.pi / max_force)).atan() * \
        (max_force / f_mag * (2.0 / math.pi))
    return deriv * scale


def integration_cycle(deriv_fn, pos, mom, dt, cache, max_force=0.0,
                      integrator="verlet"):
    """Advance one round.  deriv_fn(pos, stage, cache) returns (dU/dpos,
    new cache); per stage mom -= w_mom*dt*clip(deriv), pos +=
    w_pos*dt*mom.  The solver cache threads through the stages, so BP
    warm-starts from the previous stage's solution.  The Verlet weights
    are exactly 1, so its updates are mom - dt*d and pos + dt*mom."""
    mom_w, pos_w = INTEGRATOR_COEFFS[integrator]
    for stage in range(3):
        d, cache = deriv_fn(pos, stage, cache)
        d = clip_force(d, max_force)
        mom = mom - (dt * mom_w[stage]) * d
        pos = pos + (dt * pos_w[stage]) * mom
    return pos, mom, cache


def recenter(pos, xy_only=False):
    """Remove each replica's centre of mass (deriv_engine.cpp:37-48); with
    `xy_only` only its x and y."""
    center = pos.mean(-2, keepdim=True)
    if xy_only:
        center = center * center.new_tensor([1.0, 1.0, 0.0])
    return pos - center
