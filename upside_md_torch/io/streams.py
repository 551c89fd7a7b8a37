"""Per-node logging streams, level-gated like the reference (port of
upside_md_tpu/io/streams.py; src/state_logger.h:56-104 LOG_BASIC /
LOG_DETAILED / LOG_EXTENSIVE and the per-node add_logger registrations).

Each node type can contribute named frame streams at a minimum log level;
`stream_plan` collects them for a system in `system.specs` order, with
the JAX package's names, levels and collision suffixes, and
`make_frame_fn` evaluates the graph once a frame over the whole replica
batch and returns the potential, every stream and the hbond count:

  tip_pos, time_estimate              AFM            BASIC   bonds.cpp:130
  rama                                rama_coord     DETAILED bonds.cpp:199
  rama_map_potential                  rama_map_pot   DETAILED rama_map_pot.cpp:50
  hbond                               protein_hbond  DETAILED hbond.cpp:306
  rotamer_free_energy                 rotamer        DETAILED rotamer.cpp:661
  rotamer_1body_energy{i}             rotamer        DETAILED rotamer.cpp:668
  contact_energy                      contact        DETAILED sidechain_radial.cpp:171
  hmm_energy, hmm_energy_1body        fixed_hmm      DETAILED hmm.cpp:94
  linear_coupling_{uniform,with_inactivation}        DETAILED environment.cpp:271
  nonlinear_coupling                  nonlinear_coupling DETAILED environment.cpp:348
  virtual                             infer_H_O      EXTENSIVE hbond.cpp:48
  placement_pos                       placement_*    EXTENSIVE placement.cpp:254
  environment_coverage                environment_coverage EXTENSIVE environment.cpp:78

A stream function takes the node's prepared consts, its parameters, its
inputs (replica axis first) and the frame's force-evaluation counter, and
returns its values with the replica axis first.  Where a node's parameters
are stacked over replicas (a Hamiltonian ensemble) and the stream reads
them, it is evaluated once a slot under that slot's parameters.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from ..nodes.base import rows

LOG_BASIC, LOG_DETAILED, LOG_EXTENSIVE = 0, 1, 2
LEVEL_NAMES = {"basic": LOG_BASIC, "detailed": LOG_DETAILED,
               "extensive": LOG_EXTENSIVE}


def _afm_time(c, n_deriv_evals):
    return c.get("time_initial", 0.0) + c.get("time_step", 0.009) * \
        n_deriv_evals


def _afm_streams(spec):
    def tip_pos(c, p, inputs, n):
        tip = p["starting_tip_pos"] + p["pulling_vel"] * _afm_time(c, n)
        return tip.expand(inputs[0].shape[0], *tip.shape[-2:])

    def time_estimate(c, p, inputs, n):
        return inputs[0].new_full((inputs[0].shape[0], 1), _afm_time(c, n))

    return [("tip_pos", LOG_BASIC, tip_pos),
            ("time_estimate", LOG_BASIC, time_estimate)]


def _output_stream(name, level, column=None, width=None):
    def make(spec):
        def fn(c, p, inputs, n, out):
            if column is not None:
                return out[..., column]
            if width is not None:
                return out[..., :width]
            return out
        fn.reads_output = True
        return [(name, level, fn)]
    return make


def _rama_map_streams(spec):
    from ..nodes.rama import rama_map_pot_per_residue

    def fn(c, p, inputs, n):
        return rama_map_pot_per_residue(c, p, inputs)
    return [("rama_map_potential", LOG_DETAILED, fn)]


def _rotamer_streams(spec):
    from ..nodes.rotamer import rotamer_1body_energy, rotamer_diagnostics

    def free_energy(c, p, inputs, n):
        return rotamer_diagnostics(c, p, inputs)["rotamer_free_energy"]

    streams = [("rotamer_free_energy", LOG_DETAILED, free_energy)]
    for i in range(max(len(spec.args) - 1, 0)):   # args[0]: the beads
        def one_body(c, p, inputs, n, i=i):
            return rotamer_1body_energy(c, p, inputs, i)
        streams.append((f"rotamer_1body_energy{i}", LOG_DETAILED, one_body))
    return streams


def _contact_streams(spec):
    from ..nodes.radial import contact_energy_per_bead

    def fn(c, p, inputs, n):
        return contact_energy_per_bead(c, p, inputs)
    return [("contact_energy", LOG_DETAILED, fn)]


def _hmm_streams(spec):
    from ..nodes.hmm import hmm_energy_decomposition

    def total(c, p, inputs, n):
        return hmm_energy_decomposition(c, p, inputs)[0][:, None]

    def per_res(c, p, inputs, n):
        return hmm_energy_decomposition(c, p, inputs)[1]

    return [("hmm_energy", LOG_DETAILED, total),
            ("hmm_energy_1body", LOG_DETAILED, per_res)]


def _linear_coupling_streams(with_inactivation):
    name = ("linear_coupling_with_inactivation" if with_inactivation
            else "linear_coupling_uniform")

    def make(spec):
        def fn(c, p, inputs, n):
            coup = rows(p["couplings"], c["coupling_types"], False)
            e = coup * inputs[0][..., 0]
            if with_inactivation:
                e = e * (1.0 - inputs[1][..., c["inactivation_dim"]]) ** 2
            return e
        return [(name, LOG_DETAILED, fn)]
    return make


def _nonlinear_coupling_streams(spec):
    from ..ops.spline import eval_clamped_bspline

    def fn(c, p, inputs, n):
        coeff = rows(p["coeff"], c["coupling_types"], False)
        x = (inputs[0][..., 0] - c["spline_offset"]) * c["spline_inv_dx"]
        return eval_clamped_bspline(coeff, x)[0]
    return [("nonlinear_coupling", LOG_DETAILED, fn)]


STREAM_BUILDERS: Dict[str, Callable] = {
    "AFM": _afm_streams,
    "rama_coord": _output_stream("rama", LOG_DETAILED, width=2),
    "rama_map_pot": _rama_map_streams,
    "protein_hbond": _output_stream("hbond", LOG_DETAILED, column=6),
    "infer_H_O": _output_stream("virtual", LOG_EXTENSIVE, width=3),
    "environment_coverage": _output_stream("environment_coverage",
                                           LOG_EXTENSIVE, column=0),
    "rotamer": _rotamer_streams,
    "contact": _contact_streams,
    "fixed_hmm": _hmm_streams,
    "linear_coupling_uniform": _linear_coupling_streams(False),
    "linear_coupling_with_inactivation": _linear_coupling_streams(True),
    "nonlinear_coupling": _nonlinear_coupling_streams,
}
for _p in ("placement_scalar", "placement_fixed_scalar",
           "placement_point_only", "placement_fixed_point_only",
           "placement_point_vector_only",
           "placement_fixed_point_vector_only",
           "placement_fixed_point_vector_scalar"):
    STREAM_BUILDERS[_p] = _output_stream("placement_pos", LOG_EXTENSIVE)


def stream_plan(system, level) -> List[Tuple[str, object, Callable]]:
    """All (stream name, node spec, fn) active at `level` for this system,
    in `system.specs` order.  A name two nodes would share is suffixed
    with the node's name (several placement nodes, say)."""
    if isinstance(level, str):
        level = LEVEL_NAMES[level]
    plan, seen = [], set()
    for spec in system.specs:
        builder = STREAM_BUILDERS.get(spec.node_type.name)
        if builder is None:
            continue
        for name, min_level, fn in builder(spec):
            if level < min_level:
                continue
            if name in seen:
                name = f"{name}_{spec.name}"
            seen.add(name)
            plan.append((name, spec, fn))
    return plan


def _evaluate_stream(system, spec, fn, outputs, params, stacked, n):
    c = system.consts[spec.name]
    p = params.get(spec.name, {})
    inputs = [outputs[a] for a in spec.args]
    if getattr(fn, "reads_output", False):
        return fn(c, p, inputs, n, outputs[spec.name])
    if not stacked:
        return fn(c, p, inputs, n)
    # each slot under its own parameters
    return torch.cat([
        fn(c, {k: v[i] if k in stacked else v for k, v in p.items()},
           [x[i:i + 1] for x in inputs], n)
        for i in range(inputs[0].shape[0])])


def make_frame_fn(system, level=None):
    """One evaluation a frame over the replica batch (the reference
    evaluates the graph once a frame too, main.cpp:630-655):
    frame_fn(pos (B, n_atom, 3), params=None, n_deriv_evals=0) returns
    (potential (B,), {stream: (B, ...)}, hbond count (B,) or None), each
    slot under its own parameters where `params` stacks leaves over
    replicas.  level None: no streams.  Returns (frame_fn, has_hbond)."""
    plan = stream_plan(system, level) if level is not None else []
    hbond = next((s.name for s in system.specs
                  if s.node_type.name == "protein_hbond"), None)

    def frame_fn(pos, params=None, n_deriv_evals=0):
        params = system.params if params is None else params
        spec = system.stacked_leaves(params)
        with torch.no_grad():
            total, outputs, _, _ = system.evaluate(
                pos, params=params, n_deriv_evals=n_deriv_evals)
            streams = {
                name: _evaluate_stream(
                    system, s, fn, outputs, params,
                    frozenset(k for nd, k in spec if nd == s.name),
                    n_deriv_evals)
                for name, s, fn in plan}
            hb = n_hbond(system, outputs)
        return total, streams, hb

    return frame_fn, hbond is not None


def n_hbond(system, outputs):
    """Total hydrogen-bond count a replica (the sum of the per-virtual
    probabilities), the reference's console diagnostic
    (deriv_engine.cpp:284-288, printed by main.cpp:648-654); None
    without an hbond node."""
    for spec in system.specs:
        if spec.node_type.name == "protein_hbond":
            return outputs[spec.name][..., 6].sum(-1)
    return None
