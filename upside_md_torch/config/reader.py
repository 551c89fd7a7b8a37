"""Read a `.up` configuration with numpy alone (port of
upside_md_tpu/config/reader.py).

A `.up` is the HDF5 file the reference's upside_config.py writes: one
group a node under /input/potential, its `arguments` attribute naming the
nodes it reads, the initial structure in /input/pos and the Monte Carlo
move tables and the sequence beside it.  The file is read through
`io/h5.py`, so neither h5py nor jax is needed.  Each node type has a
translator from its group to the framework-free consts and params a
bundle stores, the same keys, dtypes and Python scalars that
`convert.from_jax_specs` makes of the JAX reader's specs; the spline
tables the reference fits at load time (Rama maps, membrane z-profiles,
Rama-dependent placements) are fitted here on the host in float64.  One
difference from a bundle: `rama_map_pot` keeps its raw map (`raw_map`),
which the reference's get_param returns and set_param replaces.

Group names resolve to node types by prefix (`placement_fixed_point_
vector_only_CB`, `hbond_coverage_hydrophobe`), as the reference's
registry does (src/deriv_engine.cpp:234-241); the type names are
prefix-free, so at most one matches.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..convert import DROPPED
from ..io import h5
from ..nodes.membrane import make_membrane_params
from ..nodes.placement import make_rama_placement_params
from ..nodes.rama import make_rama_map_params
from ..nodes.rotamer import make_rotamer_consts
from .bundle import SpecRecord

# the tables outside the node graph that a `.up` may carry under /input
# and a bundle in its aux section, beside the sequence (the JAX reader's
# aux, config/reader.py:361-370)
AUX_SECTIONS = ("pivot_moves", "jump_moves", "chain_break")


def _a(ds):
    return np.asarray(ds)


def _i(ds):
    return np.asarray(ds).astype(np.int32)


def _str(v):
    return v.decode() if isinstance(v, bytes) else str(v)


def _args(grp):
    return [_str(x) for x in np.atleast_1d(grp.attrs["arguments"])]


# --------------------------------------------------------------------------
# per-node-type translators: group -> (consts, params)
# --------------------------------------------------------------------------

def _read_pos_spring(grp):
    return ({"id": _i(grp["id"])},
            {"x0": _a(grp["x0"]), "spring_const": _a(grp["spring_const"])})


def _read_tension(grp):
    return ({"atom": _i(grp["atom"])},
            {"tension_coeff": _a(grp["tension_coeff"])})


def _read_afm(grp):
    vel = grp["pulling_vel"]
    return ({"atom": _i(grp["atom"]),
             "time_initial": float(vel.attrs["time_initial"]),
             "time_step": float(vel.attrs["time_step"])},
            {"spring_const": _a(grp["spring_const"]),
             "starting_tip_pos": _a(grp["starting_tip_pos"]),
             "pulling_vel": _a(vel)})


def _read_dist_spring(grp):
    return ({"id": _i(grp["id"]), "bonded_atoms": _i(grp["bonded_atoms"])},
            {"equil_dist": _a(grp["equil_dist"]),
             "spring_const": _a(grp["spring_const"])})


def _read_angle_spring(grp):
    return ({"id": _i(grp["id"])},
            {"equil_dp": _a(grp["equil_dist"]),
             "spring_const": _a(grp["spring_const"])})


def _read_dihedral_spring(grp):
    return ({"id": _i(grp["id"])},
            {"equil_dihedral": _a(grp["equil_dist"]),
             "spring_const": _a(grp["spring_const"])})


def _read_cavity_radial(grp):
    return ({"id": _i(grp["id"])},
            {"radius": _a(grp["radius"]),
             "spring_const": _a(grp["spring_constant"])})


def _read_z_flat_bottom(grp):
    return ({"atom": _i(grp["atom"])},
            {"z0": _a(grp["z0"]), "radius": _a(grp["radius"]),
             "spring_const": _a(grp["spring_constant"])})


def _read_rama_coord(grp):
    ids = _i(grp["id"])
    dummy = np.zeros((ids.shape[0], 2), bool)
    dummy[:, 0] = ids[:, 0] == -1
    dummy[:, 1] = ids[:, 4] == -1
    ids[dummy[:, 0], 0] = 0
    ids[dummy[:, 1], 4] = 0
    return {"id": ids, "dummy": dummy}, {}


def _read_rama_map_pot(grp):
    raw = _a(grp["rama_pot"]).astype(np.float64)
    return ({"residue_id": _i(grp["residue_id"]),
             "rama_map_id": _i(grp["rama_map_id"]),
             "raw_map": raw,
             "log_pot": int(grp.attrs.get("log_pot", 1))},
            make_rama_map_params(raw))


def _read_affine_alignment(grp):
    return {"atoms": _i(grp["atoms"]), "ref_geom": _a(grp["ref_geom"])}, {}


def _read_backbone_pairs(grp):
    ref_pos = _a(grp["ref_pos"]).astype(np.float64)
    n_atom = _i(grp["n_atom"])
    return ({"id": _i(grp["id"]),
             "ref_pos": np.where(np.isfinite(ref_pos), ref_pos, 0.0),
             "atom_mask": np.arange(4)[None, :] < n_atom[:, None]}, {})


def _read_infer_h_o(grp):
    don, acc = grp["donors"], grp["acceptors"]
    return ({"id": np.concatenate([_i(don["id"]), _i(acc["id"])]),
             "bond_length": np.concatenate([_a(don["bond_length"]),
                                            _a(acc["bond_length"])]),
             "n_donor": don["id"].shape[0],
             "donor_residue": _i(don["residue"]),
             "acceptor_residue": _i(acc["residue"])}, {})


def _read_igraph_pair(grp):
    """Index, type and id arrays of both sides and interaction_param, as
    InteractionGraph reads them (interaction_graph.h:305-381)."""
    return ({f"{k}{side}": _i(grp[f"{k}{side}"])
             for k in ("index", "type", "id") for side in "12"},
            {"interaction_param": _a(grp["interaction_param"])})


def _read_radial(grp):
    return ({k: _i(grp[k]) for k in ("index", "type", "id")},
            {"interaction_param": _a(grp["interaction_param"])})


def _read_hbond_energy(grp):
    return {}, {"protein_hbond_energy": np.asarray(
        np.float32(grp.attrs["protein_hbond_energy"]))}


def _read_contact(grp):
    return ({"id": _i(grp["id"])},
            {"energy": _a(grp["energy"]), "distance": _a(grp["distance"]),
             "width": _a(grp["width"])})


def _placement_consts(grp, *keys):
    consts = {k: _i(grp[k]) for k in ("affine_residue", "layer_index")
              + keys}
    for extra in ("beadtype_seq", "id_seq"):
        if extra in grp:
            consts[extra] = _a(grp[extra])
    return consts


def _read_placement_fixed(grp):
    return (_placement_consts(grp),
            {"placement_data": _a(grp["placement_data"])})


def _read_placement_rama(grp):
    return (_placement_consts(grp, "rama_residue"),
            make_rama_placement_params(_a(grp["placement_data"])))


def _read_weighted_pos(grp):
    return ({"index_pos": _i(grp["index_pos"]),
             "index_weight": _i(grp["index_weight"])}, {})


def _read_uniform_transform(grp):
    ds = grp["bspline_coeff"]
    return ({}, {"bspline_coeff": _a(ds),
                 "spline_offset": np.asarray(
                     np.float32(ds.attrs["spline_offset"])),
                 "spline_inv_dx": np.asarray(
                     np.float32(ds.attrs["spline_inv_dx"]))})


def _read_linear_coupling(grp):
    consts = {"coupling_types": _i(grp["coupling_types"])}
    if "inactivation_dim" in grp.attrs:
        consts["inactivation_dim"] = int(grp.attrs["inactivation_dim"])
    return consts, {"couplings": _a(grp["couplings"])}


def _read_nonlinear_coupling(grp):
    ds = grp["coeff"]
    return ({"coupling_types": _i(grp["coupling_types"]),
             "spline_offset": float(ds.attrs["spline_offset"]),
             "spline_inv_dx": float(ds.attrs["spline_inv_dx"])},
            {"coeff": _a(ds)})


def _read_rotamer(grp):
    pg = grp["pair_interaction"]
    consts = make_rotamer_consts(
        _a(pg["id"]), _i(pg["index"]), _i(pg["type"]),
        damping=float(grp.attrs["damping"]),
        max_iter=int(grp.attrs["max_iter"]), tol=float(grp.attrs["tol"]))
    consts["iteration_chunk_size"] = int(
        grp.attrs.get("iteration_chunk_size", 1))
    return consts, {"interaction_param": _a(pg["interaction_param"])}


def _read_membrane(grp):
    cb, uhb = grp["cb_energy"], grp["uhb_energy"]
    consts = {k: _i(grp[k]) for k in ("cb_index", "env_index",
                                      "residue_type")}
    consts.update(cov_midpoint=_a(grp["cov_midpoint"]),
                  cov_sharpness=_a(grp["cov_sharpness"]))
    for name, ds in (("cb", cb), ("uhb", uhb)):
        z_min, z_max = float(ds.attrs["z_min"]), float(ds.attrs["z_max"])
        consts[f"{name}_z_shift"] = -z_min
        consts[f"{name}_z_scale"] = (ds.shape[1] - 1) / (z_max - z_min)
    consts["n_donor"] = grp["donor_residue_ids"].shape[0]
    return consts, make_membrane_params(_a(cb), _a(uhb))


def _read_constant(grp):
    return {}, {"value": _a(grp["value"])}


def _read_slice(grp):
    return {"id": _i(grp["id"])}, {}


def _read_concat(grp):
    return {}, {}


def _read_fixed_hmm(grp):
    return ({"index": _i(grp["index"])},
            {"transition_energy": _a(grp["transition_energy"])})


def _read_torus_dbn(grp):
    return ({"id": _i(grp["id"]), "restypes": _i(grp["restypes"]),
             "basin_param": _a(grp["basin_param"])},
            {"prior_offset_energies": _a(grp["prior_offset_energies"])})


def _read_backbone_featurizer(grp):
    hb = _i(grp["hbond_idx"])
    return ({"rama_idx": _i(grp["rama_idx"]),
             "donor_idx": hb[:, 0], "acceptor_idx": hb[:, 1]}, {})


def _read_conv1d(grp):
    act = grp.attrs["activation"]
    if isinstance(act, (list, np.ndarray)):
        act = act[0]
    return ({"activation": _str(act)},
            {"weights": _a(grp["weights"]), "bias": _a(grp["bias"])})


def _read_scaled_sum(grp):
    return {"scale": float(grp.attrs["scale"])}, {}


# in the JAX registry's order; a group name resolves to the type its name
# starts with
READERS = {
    "affine_alignment": _read_affine_alignment,
    "constant": _read_constant,
    "slice": _read_slice,
    "concat": _read_concat,
    "atom_pos_spring": _read_pos_spring,
    "tension": _read_tension,
    "AFM": _read_afm,
    "dist_spring": _read_dist_spring,
    "cavity_radial": _read_cavity_radial,
    "z_flat_bottom": _read_z_flat_bottom,
    "angle_spring": _read_angle_spring,
    "dihedral_spring": _read_dihedral_spring,
    "rama_coord": _read_rama_coord,
    "environment_coverage": _read_igraph_pair,
    "weighted_pos": _read_weighted_pos,
    "uniform_transform": _read_uniform_transform,
    "linear_coupling_uniform": _read_linear_coupling,
    "linear_coupling_with_inactivation": _read_linear_coupling,
    "nonlinear_coupling": _read_nonlinear_coupling,
    "infer_H_O": _read_infer_h_o,
    "protein_hbond": _read_igraph_pair,
    "hbond_energy": _read_hbond_energy,
    "hbond_coverage": _read_igraph_pair,
    "fixed_hmm": _read_fixed_hmm,
    "torus_dbn": _read_torus_dbn,
    "membrane_potential": _read_membrane,
    "backbone_featurizer": _read_backbone_featurizer,
    "conv1d": _read_conv1d,
    "scaled_sum": _read_scaled_sum,
    "rama_map_pot": _read_rama_map_pot,
    "placement_scalar": _read_placement_rama,
    "placement_fixed_scalar": _read_placement_fixed,
    "placement_point_only": _read_placement_rama,
    "placement_fixed_point_only": _read_placement_fixed,
    "placement_point_vector_only": _read_placement_rama,
    "placement_fixed_point_vector_only": _read_placement_fixed,
    "placement_fixed_point_vector_scalar": _read_placement_fixed,
    "radial": _read_radial,
    "hbond_sc_radial": _read_igraph_pair,
    "contact": _read_contact,
    "rotamer": _read_rotamer,
    "backbone_pairs": _read_backbone_pairs,
}


def resolve_type_name(group_name: str) -> str:
    """The node type a config group name starts with."""
    for prefix in READERS:
        if group_name.startswith(prefix):
            return prefix
    raise KeyError(f"no node type found for config group '{group_name}'")


def read_node(name, grp) -> SpecRecord:
    """One /input/potential group -> its SpecRecord, without the entries
    the port never reads (convert.DROPPED) but with rama_map_pot's raw
    map."""
    type_name = resolve_type_name(name)
    consts, params = READERS[type_name](grp)
    drop = DROPPED.get(type_name, set()) - {"raw_map"}
    return SpecRecord(name, type_name, _args(grp),
                      {k: v for k, v in consts.items() if k not in drop},
                      params)


def read_aux(f) -> Dict[str, Dict[str, np.ndarray]]:
    """The aux tables of an open `.up`, in a bundle's aux layout: each of
    AUX_SECTIONS present with its float tables in float32 (as
    `tools/export_torch_bundle.export_up` stores them), and the sequence
    as section `input`."""
    aux = {}
    for sec in AUX_SECTIONS:
        if f"input/{sec}" in f:
            g = f[f"input/{sec}"]
            aux[sec] = {k: a.astype(np.float32) if a.dtype.kind == "f"
                        else a for k, a in ((k, _a(g[k])) for k in g)}
    if "input/sequence" in f:
        aux["input"] = {"sequence": np.asarray(
            [_str(s) for s in _a(f["input/sequence"])], "S")}
    return aux


def load_up(path) -> Tuple[List[SpecRecord], np.ndarray, Dict]:
    """Read a `.up`: (SpecRecords in the file's group order, initial
    positions (n_atom, 3) float32, aux)."""
    with h5.File(path) as f:
        pot = f["input/potential"]
        records = [read_node(name, pot[name]) for name in pot]
        pos = _a(f["input/pos"])
        aux = read_aux(f)
    if pos.ndim == 3:
        pos = pos[:, :, 0]
    return records, pos.astype(np.float32), aux
