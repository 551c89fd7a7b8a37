"""A hand-built graph of the node types no config-builder method writes.

The JAX reader reads each of them from a `.up` (upside_md_tpu/config/
reader.py:300-340), but nothing in the repository builds one.
`extras_graph` adds them to the records of a bundle that has the backbone
chain (`affine_alignment`, `rama_coord`, `infer_H_O`, `protein_hbond`)
and the burial chain (`environment_coverage`), with seeded numpy data:

* constant_anchor (constant) -> concat_anchor (concat of slice_ca, a
  slice of the CA atoms, and the anchors) -> atom_pos_spring_anchor;
* placement_point_only_probe and placement_point_vector_only_probe: a
  Rama-dependent probe per residue; hbond_sc_radial_probe between the
  second and the hbond virtual sites;
* uniform_transform_burial of the environment coverage ->
  linear_coupling_uniform_burial and, gated by the donor hbond column of
  backbone_featurizer, linear_coupling_with_inactivation_burial;
* backbone_featurizer -> conv1d_hidden (Tanh) -> conv1d_out (ReLU) ->
  scaled_sum_out.

The tests hold each node against the JAX package on it and the smoke run
evaluates it on the card.
"""

from __future__ import annotations

import numpy as np

from .bundle import SpecRecord

EXTRAS_SEED = 11
# the node of each of the 24 types the older bundles do not use, in
# trp_cage_extras_synth and the hand-built graph on it
EXTRAS_NODES = {
    "placement_fixed_scalar": "placement_fixed_scalar",
    "placement_fixed_point_only": "placement_fixed_point_only_CB",
    "placement_point_only": "placement_point_only_probe",
    "placement_point_vector_only": "placement_point_vector_only_probe",
    "radial": "radial",
    "hbond_sc_radial": "hbond_sc_radial_probe",
    "contact": "contact",
    "constant": "constant_anchor",
    "slice": "slice_ca",
    "concat": "concat_anchor",
    "atom_pos_spring": "atom_pos_spring_anchor",
    "tension": "tension",
    "AFM": "AFM",
    "cavity_radial": "cavity_radial",
    "z_flat_bottom": "z_flat_bottom",
    "uniform_transform": "uniform_transform_burial",
    "linear_coupling_uniform": "linear_coupling_uniform_burial",
    "linear_coupling_with_inactivation":
        "linear_coupling_with_inactivation_burial",
    "membrane_potential": "membrane_potential",
    "fixed_hmm": "fixed_hmm",
    "torus_dbn": "torus_dbn",
    "backbone_featurizer": "backbone_featurizer",
    "conv1d": "conv1d_hidden",
    "scaled_sum": "scaled_sum_out",
}
N_ANCHOR = 4
N_GRID = 12          # Rama grid of the probe placements' spline surfaces


def _smooth_surface(rng, n_layer, base, amp):
    """Spline coefficients (n_layer, N_GRID, N_GRID, width): `base` plus a
    low-order periodic modulation in phi and psi."""
    g = 2 * np.pi * np.arange(N_GRID) / N_GRID
    phi, psi = np.meshgrid(g, g, indexing="ij")
    out = np.empty((n_layer, N_GRID, N_GRID, len(base)))
    for layer in range(n_layer):
        a = rng.normal(size=(4, len(base)))
        out[layer] = base + amp * (
            a[0] * np.cos(phi)[..., None] + a[1] * np.sin(phi)[..., None]
            + a[2] * np.cos(psi)[..., None] + a[3] * np.sin(psi)[..., None])
    return out.astype(np.float32)


def extras_graph(records, pos, seed=EXTRAS_SEED):
    """`records` (bundle SpecRecords) with the hand-built nodes appended;
    `pos` the bundle's initial positions (n_atom, 3)."""
    rng = np.random.default_rng(seed)
    by = {r.name: r for r in records}
    n_res = len(by["rama_coord"].consts["id"])
    ho = by["infer_H_O"].consts
    n_donor = int(ho["n_donor"])
    donors = np.asarray(ho["donor_residue"])
    acceptors = np.asarray(ho["acceptor_residue"])
    n_virt = n_donor + len(acceptors)
    res = np.arange(n_res)
    pos = np.asarray(pos, np.float64)
    out = list(records)

    def add(name, type_name, args, consts=None, params=None):
        out.append(SpecRecord(name, type_name, list(args), consts or {},
                              params or {}))

    ca = 3 * res + 1
    anchors = pos[ca].mean(0) + 2.0 * rng.normal(size=(N_ANCHOR, 3))
    add("constant_anchor", "constant", [],
        params={"value": anchors.astype(np.float32)})
    add("slice_ca", "slice", ["pos"], {"id": ca.astype(np.int32)})
    add("concat_anchor", "concat", ["slice_ca", "constant_anchor"])
    x0 = np.concatenate([pos[ca], anchors]) + 0.3 * rng.normal(
        size=(n_res + N_ANCHOR, 3))
    add("atom_pos_spring_anchor", "atom_pos_spring", ["concat_anchor"],
        {"id": np.arange(n_res + N_ANCHOR, dtype=np.int32)},
        {"x0": x0.astype(np.float32),
         "spring_const": np.full(n_res + N_ANCHOR, 0.5, np.float32)})

    probe = {"affine_residue": res.astype(np.int32),
             "rama_residue": res.astype(np.int32),
             "layer_index": (res % 2).astype(np.int32)}
    point = np.array([0.0, 1.6, 1.9])
    add("placement_point_only_probe", "placement_point_only",
        ["affine_alignment", "rama_coord"], dict(probe),
        {"coeffs": _smooth_surface(rng, 2, point, 0.3)})
    direction = np.array([0.0, 0.6, 0.8])
    add("placement_point_vector_only_probe", "placement_point_vector_only",
        ["affine_alignment", "rama_coord"], dict(probe),
        {"coeffs": _smooth_surface(rng, 2, np.concatenate([point,
                                                           direction]),
                                   0.2)})

    # [inv_dx, 16 knots]: an attractive well that reaches 0 at the cutoff
    knots = -0.3 * np.sin(np.linspace(0.0, np.pi, 16)) ** 2
    knots[-3:] = 0.0
    table = np.zeros((2, 2, 17))
    table[..., 0] = 2.0
    table[..., 1:] = knots * rng.uniform(0.5, 1.5, size=(2, 2, 1))
    add("hbond_sc_radial_probe", "hbond_sc_radial",
        ["placement_point_vector_only_probe", "infer_H_O"],
        {"index1": res.astype(np.int32),
         "type1": (res % 2).astype(np.int32), "id1": res.astype(np.int32),
         "index2": np.arange(n_virt, dtype=np.int32),
         "type2": (np.arange(n_virt) >= n_donor).astype(np.int32),
         "id2": np.concatenate([donors, acceptors]).astype(np.int32)},
        {"interaction_param": table.astype(np.float32)})

    add("uniform_transform_burial", "uniform_transform",
        ["environment_coverage"],
        params={"bspline_coeff": np.cumsum(rng.uniform(
            0.0, 0.4, 12)).astype(np.float32),
            # burial 0-2 falls on the spline's sloped part
            "spline_offset": np.float32(-2.0),
            "spline_inv_dx": np.float32(1.0)})
    add("backbone_featurizer", "backbone_featurizer",
        ["rama_coord", "protein_hbond"],
        {"rama_idx": res.astype(np.int32),
         "donor_idx": np.array([int(np.flatnonzero(donors == r)[0])
                                if r in donors else -1 for r in res],
                               np.int32),
         "acceptor_idx": np.array(
             [n_donor + int(np.flatnonzero(acceptors == r)[0])
              if r in acceptors else -1 for r in res], np.int32)})
    types = (res % 4).astype(np.int32)
    add("linear_coupling_uniform_burial", "linear_coupling_uniform",
        ["uniform_transform_burial"], {"coupling_types": types},
        {"couplings": rng.normal(scale=0.2, size=4).astype(np.float32)})
    add("linear_coupling_with_inactivation_burial",
        "linear_coupling_with_inactivation",
        ["uniform_transform_burial", "backbone_featurizer"],
        {"coupling_types": types, "inactivation_dim": 4},
        {"couplings": rng.normal(scale=0.2, size=4).astype(np.float32)})

    def conv(width, c_in, c_out, bias):
        return {"weights": (rng.normal(size=(width, c_in, c_out))
                            / np.sqrt(width * c_in)).astype(np.float32),
                "bias": np.full(c_out, bias, np.float32)}
    add("conv1d_hidden", "conv1d", ["backbone_featurizer"],
        {"activation": "Tanh"}, conv(3, 6, 5, 0.0))
    add("conv1d_out", "conv1d", ["conv1d_hidden"], {"activation": "ReLU"},
        conv(3, 5, 1, 0.5))
    add("scaled_sum_out", "scaled_sum", ["conv1d_out"], {"scale": 0.3})
    return out
