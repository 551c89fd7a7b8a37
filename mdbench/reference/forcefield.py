"""Plain reference of the Upside force field that the benchmark's cells run.

It reads a configuration bundle (`upside_md_torch/data/*.npz`, a numpy
archive with a JSON index) with numpy alone and evaluates every node type of
the full force field on dense arrays: no kernel, no pair cull, no neighbour
list, no fused block, no warm start, no cache.  It imports nothing of the
program and works out again, from the bundle's raw tables, whatever the
program's set-up derives from them (polynomial spline coefficients, masks,
slot tables, the rotamer problem's statics).

The formulas follow the reference C++ engine (src/bonds.cpp, eig.cpp,
backbone_steric.cpp, placement.cpp, hbond.cpp, environment.cpp,
rotamer.cpp, spline.h, bead_interaction.h) as the JAX package restates
them.  Departures from the program's formulation, each exact in exact
arithmetic: the rigid alignment takes the largest eigenvector of the
Coutsias matrix from `torch.linalg.eigh` (the program runs Newton on the
characteristic quartic); the pair splines are evaluated as B-splines from
the table's knots (the program expands them into per-interval cubic
polynomials); every pair sum is a plain dense sum; the rotamer node solves
BP cold to a tight tolerance (`bp.py`) and carries its gradient by the
envelope theorem.

Energies are (B,) for positions (B, n_atom, 3); gradients come from
autograd.  Parameters can be replaced (`params=`), so training's table
gradients come from autograd too.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

from . import bp

NROT = 6
DUMMY_ANGLE = -1.3963   # the engine's -80 degrees (bonds.cpp:220)


def load_bundle(path):
    """(nodes, pos): nodes a list of {name, type, args, consts, params} in
    file order, pos (n_atom, 3) float32, from a bundle's numpy archive."""
    with np.load(path, allow_pickle=False) as z:
        index = json.loads(bytes(z["__index__"]).decode())
        pos = np.asarray(z["pos"])

        def unpack(desc, prefix):
            return {key: np.asarray(z[f"{prefix}/{key}"]) if "array" in d
                    else d["scalar"] for key, d in desc.items()}

        nodes = [{"name": e["name"], "type": e["type"],
                  "args": list(e["args"]),
                  "consts": unpack(e["consts"], f"{k}/consts"),
                  "params": unpack(e["params"], f"{k}/params")}
                 for k, e in enumerate(index["specs"])]
    return nodes, pos


# -- geometry -----------------------------------------------------------------

def norm(v):
    return torch.sqrt((v * v).sum(-1))


def dihedral(r1, r2, r3, r4):
    """Dihedral in (-pi, pi] with the engine's sign (vector_math.h:703)."""
    F, G, H = r1 - r2, r2 - r3, r4 - r3
    A = torch.cross(F, G, dim=-1)
    B = torch.cross(H, G, dim=-1)
    C = torch.cross(B, A, dim=-1)
    return torch.atan2((C * G).sum(-1), (A * B).sum(-1) * norm(G))


def quat_to_rot(q):
    """Unit quaternion [a, b, c, d] -> rotation matrix (affine.h:98)."""
    a, b, c, d = q.unbind(-1)
    r = torch.stack([
        a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c),
        2 * (b * c + a * d), a * a - b * b + c * c - d * d, 2 * (c * d - a * b),
        2 * (b * d - a * c), 2 * (c * d + a * b), a * a - b * b - c * c + d * d,
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def rotate(R, v):
    return (R * v.unsqueeze(-2)).sum(-1)


def rigid_alignment(atoms, ref):
    """Centre and quaternion that rotates `ref` (centred) onto the centred
    `atoms` (..., 3, 3): the largest eigenvector of the 4x4 Coutsias
    matrix (eig.cpp:277-386).  Its sign is arbitrary; the rotation is not."""
    center = atoms.mean(-2)
    x = atoms - center.unsqueeze(-2)
    R = (ref.unsqueeze(-1) * x.unsqueeze(-2)).sum(-3)
    (R00, R01, R02), (R10, R11, R12), (R20, R21, R22) = [
        R[..., i, :].unbind(-1) for i in range(3)]
    F = torch.stack([
        torch.stack([R00 + R11 + R22, R12 - R21, R20 - R02, R01 - R10], -1),
        torch.stack([R12 - R21, R00 - R11 - R22, R01 + R10, R02 + R20], -1),
        torch.stack([R20 - R02, R01 + R10, -R00 + R11 - R22, R12 + R21], -1),
        torch.stack([R01 - R10, R02 + R20, R12 + R21, -R00 - R11 + R22], -1),
    ], dim=-2)
    # eigh has no half-precision kernel: a control in bfloat16 solves the
    # 4x4 problem in float32 and rounds the vector back
    solve_dtype = F.dtype if F.dtype in (torch.float32, torch.float64) \
        else torch.float32
    _, vec = torch.linalg.eigh(torch.nan_to_num(F.to(solve_dtype)))
    return center, vec[..., -1].to(F.dtype)


def compact_sigmoid(x, sharpness):
    """1 below -1/sharpness, 0 above 1/sharpness, 0.25 (y+2)(y-1)^2 between,
    y = x sharpness (vector_math.h:640-658)."""
    y = torch.clamp(x * sharpness, -1.0, 1.0)
    return 0.25 * (y + 2.0) * (y - 1.0) * (y - 1.0)


# -- splines ------------------------------------------------------------------

def bspline_weights(t):
    s = 1.0 - t
    return torch.stack([s * s * s, 3 * t * t * t - 6 * t * t + 4,
                        -3 * t * t * t + 3 * t * t + 3 * t + 1,
                        t * t * t], -1) / 6.0


def bspline(coef, x):
    """Uniform cubic B-spline with knots on the integers, coefficient m
    centred at m - 1, at x in [1, n - 2] (spline.h:97-128); coef (..., n)
    broadcasts against x (...)."""
    n = coef.shape[-1]
    # a non-finite coordinate (a diverging low-precision control) indexes
    # a valid window and stays non-finite in the value
    i = torch.clamp(torch.floor(torch.nan_to_num(x.detach())), 1, n - 3)
    t = x - i
    idx = (i.long() - 1).unsqueeze(-1) + torch.arange(4, device=x.device)
    shape = torch.broadcast_shapes(coef.shape[:-1], x.shape)
    c = torch.gather(coef.expand(shape + (n,)), -1, idx.expand(shape + (4,)))
    return (bspline_weights(t) * c).sum(-1)


def clamped_bspline(coef, x):
    """Constant value and zero slope outside [1, n - 2] (spline.h:268)."""
    return bspline(coef, torch.clamp(x, 1.0, coef.shape[-1] - 2.0))


def periodic_bspline_2d(coef, x, y):
    """Periodic bicubic surface coef (..., nx, ny) at grid coordinates x, y
    (...), indices wrapping (spline.h:434-450)."""
    nx, ny = coef.shape[-2:]
    ix = torch.floor(torch.nan_to_num(x.detach()))
    iy = torch.floor(torch.nan_to_num(y.detach()))
    wx, wy = bspline_weights(x - ix), bspline_weights(y - iy)
    off = torch.arange(-1, 3, device=x.device)
    rows = torch.remainder(ix.long().unsqueeze(-1) + off, nx)
    cols = torch.remainder(iy.long().unsqueeze(-1) + off, ny)
    shape = torch.broadcast_shapes(coef.shape[:-2], x.shape)
    c = coef.expand(shape + (nx, ny))
    c = torch.gather(c, -2, rows.expand(shape + (4,)).unsqueeze(-1)
                     .expand(shape + (4, ny)))
    c = torch.gather(c, -1, cols.expand(shape + (4,)).unsqueeze(-2)
                     .expand(shape + (4, 4)))
    return (c * wx.unsqueeze(-1) * wy.unsqueeze(-2)).sum((-1, -2))


def rama_to_grid(angle, n):
    """Angle in (-pi, pi] -> grid coordinate (rama_map_pot.cpp:66-76)."""
    return (angle + math.pi) * (n * (0.5 / math.pi - 1e-7))


# parameter count of a directional pair table -> (angular knots, distance
# knots, knot spacing) (bead_interaction.h:12-27)
PAIR_FAMILIES = {34: (8, 9, 1.0), 30: (8, 7, 1.0), 62: (15, 16, 0.5),
                 54: (15, 12, 0.5), 40: (8, 12, 1.0)}


def pair_family(width):
    if width not in PAIR_FAMILIES:
        raise ValueError(f"no pair-spline family has {width} parameters")
    return PAIR_FAMILIES[width]


def pair_cutoff(width):
    """Distance beyond which a pair of this table contributes nothing."""
    _, k, dx = pair_family(width)
    return (k - 2 - 1e-6) * dx


def pair_grid(table, t1, t2, x1, x2, mask):
    """Directional pair spline (bead_interaction.h:30-84) of every pair of
    rows x1 (B, n1, 6) and columns x2 (B, n2, 6), each (position, unit
    direction): wide(r) + ang1(cos1) ang2(cos2) narrow(r) where `mask`
    (n1, n2) holds and r is inside the cutoff, else 0.  (B, n1, n2)."""
    ka, k, dx = pair_family(table.shape[-1])
    d = x2[:, None, :, 0:3] - x1[:, :, None, 0:3]
    d2 = (d * d).sum(-1)
    live = mask & (d2 < ((k - 2 - 1e-6) * dx) ** 2)
    # dead pairs get a harmless unit distance, so no NaN reaches a gradient;
    # so do two sites that coincide (in bfloat16 a bead can round onto an
    # hbond site), which no finite-precision distance tells apart
    dist = torch.sqrt(torch.where(live, d2, torch.ones_like(d2))
                      .clamp(min=1e-12))
    u = d / dist.unsqueeze(-1)
    cos1 = (x1[:, :, None, 3:6] * u).sum(-1)
    cos2 = -(x2[:, None, :, 3:6] * u).sum(-1)
    T = table[t1[:, None], t2[None, :]]                 # (n1, n2, width)
    ang = (ka - 3) / 2.0
    a1 = bspline(T[..., :ka], (cos1 + 1.0) * ang + 1.0)
    a2 = bspline(T[..., ka:2 * ka], (cos2 + 1.0) * ang + 1.0)
    s = dist / dx
    wide = clamped_bspline(T[..., 2 * ka:2 * ka + k], s)
    narrow = clamped_bspline(T[..., 2 * ka + k:], s)
    return torch.where(live, wide + a1 * a2 * narrow, torch.zeros_like(d2))


def exclusion(id1, id2, min_sep=2):
    d = id1[:, None] - id2[None, :]
    return (d > min_sep) | (d < -min_sep)


# -- node types: compute(consts, params, inputs) -> output ----------------------

def _dist_spring(c, p, x):
    d = norm(x[0][:, c["id"][:, 0]] - x[0][:, c["id"][:, 1]])
    return 0.5 * (p["spring_const"] * (d - p["equil_dist"]) ** 2).sum(-1)


def _angle_spring(c, p, x):
    a3 = x[0][:, c["id"][:, 2]]
    v1, v2 = x[0][:, c["id"][:, 0]] - a3, x[0][:, c["id"][:, 1]] - a3
    dp = (v1 * v2).sum(-1) / (norm(v1) * norm(v2))
    return 0.5 * (p["spring_const"] * (dp - p["equil_dp"]) ** 2).sum(-1)


def _dihedral_spring(c, p, x):
    i = c["id"]
    a = dihedral(*(x[0][:, i[:, k]] for k in range(4)))
    disp = torch.remainder(a - p["equil_dihedral"] + math.pi,
                           2 * math.pi) - math.pi
    return 0.5 * (p["spring_const"] * disp * disp).sum(-1)


def _rama_coord(c, p, x):
    """(phi, psi) of each residue from [prev C, N, CA, C, next N]; a
    missing neighbour gives the engine's dummy angle (bonds.cpp:190-226)."""
    a = x[0][:, c["id"]]
    dummy = c["dummy"]
    # a stand-in for a missing atom, off the line, so no NaN reaches the
    # gradient of the branch that is thrown away
    a0 = torch.where(dummy[:, 0:1], a[:, :, 1] + a.new_tensor(
        [1.3, 0.7, 0.9]), a[:, :, 0])
    a4 = torch.where(dummy[:, 1:2], a[:, :, 3] + a.new_tensor(
        [0.9, 1.3, 0.7]), a[:, :, 4])
    phi = dihedral(a0, a[:, :, 1], a[:, :, 2], a[:, :, 3])
    psi = dihedral(a[:, :, 1], a[:, :, 2], a[:, :, 3], a4)
    fill = torch.full_like(phi, DUMMY_ANGLE)
    return torch.stack([torch.where(dummy[:, 0], fill, phi),
                        torch.where(dummy[:, 1], fill, psi)], -1)


def _affine_alignment(c, p, x):
    center, quat = rigid_alignment(x[0][:, c["atoms"]], c["ref_geom"])
    return torch.cat([center, quat], -1)


def _backbone_pairs(c, p, x):
    """Steric repulsion of up to four frame-placed atoms a residue, between
    residues more than one apart (backbone_steric.cpp): 4 x compact
    sigmoid((r^2 - 9) / (3 x 0.1))."""
    aff = x[0][:, c["id"]]
    R = quat_to_rot(aff[..., 3:7])
    atoms = rotate(R.unsqueeze(-3), c["ref_pos"]) + aff[..., None, 0:3]
    ax = atoms.reshape(atoms.shape[0], -1, 3)
    d = ax[:, None] - ax[:, :, None]
    v = compact_sigmoid((d * d).sum(-1) - 9.0, 1.0 / 0.3)
    rid = c["id"].repeat_interleave(4)
    ok = c["atom_mask"].reshape(-1).bool()
    pair = (rid[:, None] - rid[None, :] < -1) & ok[:, None] & ok[None, :]
    return 4.0 * torch.where(pair, v, torch.zeros_like(v)).sum((-1, -2))


def _placed(signature):
    """Place each element's local data with its residue's frame: points
    R v + t, vectors R v, scalars unchanged (placement.cpp)."""
    def place(aff, val):
        t, R = aff[..., 0:3], quat_to_rot(aff[..., 3:7])
        out, off = [], 0
        for kind in signature:
            w = 1 if kind == "scalar" else 3
            v = val[..., off:off + w]
            out.append(rotate(R, v) + t if kind == "point" else
                       rotate(R, v) if kind == "vector" else
                       v.expand(aff.shape[:-1] + (1,)))
            off += w
        return torch.cat(out, -1)
    return place


def _fixed_placement(signature):
    place = _placed(signature)

    def compute(c, p, x):
        return place(x[0][:, c["affine_residue"]],
                     p["placement_data"][c["layer_index"]])
    return compute


def _placement_scalar(c, p, x):
    """A scalar a bead from its residue's (phi, psi) through a periodic
    bicubic map of its layer."""
    rama = x[1][:, c["rama_residue"]]
    coef = p["coeffs"][c["layer_index"]][..., 0]        # (n, nx, ny)
    val = periodic_bspline_2d(coef, rama_to_grid(rama[..., 0], coef.shape[-2]),
                              rama_to_grid(rama[..., 1], coef.shape[-1]))
    return val.unsqueeze(-1)


def _rama_map_pot(c, p, x):
    rama = x[0][:, c["residue_id"]]
    coef = p["coeffs"][c["rama_map_id"]]
    return periodic_bspline_2d(
        coef, rama_to_grid(rama[..., 0], coef.shape[-2]),
        rama_to_grid(rama[..., 1], coef.shape[-1])).sum(-1)


def _unit(v):
    return v / norm(v).unsqueeze(-1)


def _infer_h_o(c, p, x):
    """Virtual amide H and carbonyl O: the site bond_length along minus the
    bisector of the two bonds of the middle atom (hbond.cpp)."""
    ids = c["id"]
    mid = x[0][:, ids[:, 1]]
    direction = -_unit(_unit(x[0][:, ids[:, 0]] - mid)
                       + _unit(x[0][:, ids[:, 2]] - mid))
    return torch.cat([mid + c["bond_length"][:, None] * direction,
                      direction], -1)


def _protein_hbond(c, p, x):
    """Each donor's and acceptor's hbond probability 1 - prod(1 - hb) over
    its partners (hbond.cpp:153-230)."""
    don, acc = x[0][:, c["index1"]], x[0][:, c["index2"]]
    prm = p["interaction_param"][c["type1"][:, None], c["type2"][None, :]]
    H, rHN = don[..., None, 0:3], don[..., None, 3:6]
    O, rOC = acc[..., None, :, 0:3], acc[..., None, :, 3:6]
    HO = H - O
    raw2 = (HO * HO).sum(-1)
    dist = torch.sqrt(raw2 + 1e-6)
    rHO = HO / dist.unsqueeze(-1)
    dotHOC = (rHO * rOC).sum(-1)
    dotOHN = -(rHO * rHN).sum(-1)
    radial = torch.sigmoid((prm[..., 2] - dist) * prm[..., 3]) \
        * torch.sigmoid((dist - prm[..., 0]) * prm[..., 1])
    angular = torch.sigmoid((dotHOC - prm[..., 4]) * prm[..., 5]) \
        * torch.sigmoid((dotOHN - prm[..., 4]) * prm[..., 5])
    within = (dotHOC > 0) & (dotOHN > 0) & (raw2 < 3.5 * 3.5)
    hb = torch.where(within, radial * angular, torch.zeros_like(raw2))
    # -log(1 - hb) with the engine's floor and cap (hbond.cpp:221-223)
    lg = torch.where(hb >= 1.0, torch.full_like(hb, 100.0),
                     -torch.log(torch.clamp(1.0 - hb, min=1e-5)))
    prob = 1.0 - torch.exp(-torch.cat([lg.sum(-1), lg.sum(-2)], -1))
    return torch.cat([torch.cat([don, acc], -2), prob.unsqueeze(-1)], -1)


def _hbond_energy(c, p, x):
    return p["protein_hbond_energy"] * x[0][..., 6].sum(-1)


def _hbond_coverage(c, p, x):
    """Coverage of each bead: sum over the rows (hbond sites or
    hydrophobes) of (1 - row scalar)^2 times the pair spline."""
    rows, cols = x[0][:, c["index1"]], x[1][:, c["index2"]]
    w = (1.0 - rows[..., 6]) ** 2
    grid = pair_grid(p["interaction_param"], c["type1"], c["type2"],
                     rows[..., :6], cols[..., :6],
                     exclusion(c["id1"], c["id2"]))
    return (w.unsqueeze(-1) * grid).sum(1).unsqueeze(-1)


def _weighted_pos(c, p, x):
    return torch.cat([x[0][:, c["index_pos"], 0:3],
                      torch.exp(-x[1][:, c["index_weight"], 0:1])], -1)


def _environment_coverage(c, p, x):
    """Direction-weighted burial of each CB: sum over beads of the bead's
    weight times radial and angular compact sigmoids (environment.cpp)."""
    cb, sc = x[0][:, c["index1"]], x[1][:, c["index2"]]
    prm = p["interaction_param"][c["type1"][:, None], c["type2"][None, :]]
    r0, r_sharp, dot0, dot_sharp = prm.unbind(-1)
    d = sc[:, None, :, 0:3] - cb[:, :, None, 0:3]
    d2 = (d * d).sum(-1)
    cut = r0 + 1.0 / r_sharp
    live = exclusion(c["id1"], c["id2"]) & (d2 < cut * cut)
    dist = torch.sqrt(torch.where(live, d2, torch.ones_like(d2))
                      .clamp(min=1e-12))
    dp = (d * cb[:, :, None, 3:6]).sum(-1) / dist
    score = sc[:, None, :, 3] * compact_sigmoid(dist - r0, r_sharp) \
        * compact_sigmoid(dot0 - dp, dot_sharp)
    return torch.where(live, score, torch.zeros_like(d2)).sum(-1) \
        .unsqueeze(-1)


def _nonlinear_coupling(c, p, x):
    coef = p["coeff"][c["coupling_types"]]
    s = (x[0][..., 0] - c["spline_offset"]) * c["spline_inv_dx"]
    return clamped_bspline(coef, s).sum(-1)


def _rotamer(c, p, x, tol, max_iter):
    """Side-chain free energy: the Bethe free energy of the residues'
    rotamer states under the beads' 1-body energies (the sum of the node's
    energy inputs) and the bead-pair spline, solved by loopy BP
    (rotamer.cpp).  The residue problem is built by one-hot products from
    the beads' (residue, rotamer) slots."""
    beads = x[0][:, c["index"], :6]
    e_bead = sum(inp[:, c["index"], 0] for inp in x[1:])
    n_res = int(c["n_res"])
    S = torch.nn.functional.one_hot(c["res"] * NROT + c["rot"],
                                    n_res * NROT).to(beads.dtype)
    res = c["res"]
    upper = torch.triu(torch.ones(len(res), len(res), dtype=torch.bool,
                                  device=res.device), 1)
    grid = pair_grid(p["interaction_param"], c["type"], c["type"], beads,
                     beads, upper & (res[:, None] != res[None, :]))
    B = beads.shape[0]
    E1 = (e_bead @ S).reshape(B, n_res, NROT)
    E2 = (S.T @ (grid + grid.transpose(1, 2)) @ S).reshape(
        B, n_res, NROT, n_res, NROT).permute(0, 1, 3, 2, 4)
    return bp.free_energy(E1, E2, c["valid"].bool(), float(c["damping"]),
                          tol, max_iter)


COMPUTE = {
    "dist_spring": _dist_spring, "angle_spring": _angle_spring,
    "dihedral_spring": _dihedral_spring, "rama_coord": _rama_coord,
    "affine_alignment": _affine_alignment, "backbone_pairs": _backbone_pairs,
    "placement_fixed_point_vector_only":
        _fixed_placement(("point", "vector")),
    "placement_fixed_point_vector_scalar":
        _fixed_placement(("point", "vector", "scalar")),
    "placement_scalar": _placement_scalar, "rama_map_pot": _rama_map_pot,
    "infer_H_O": _infer_h_o, "protein_hbond": _protein_hbond,
    "hbond_energy": _hbond_energy, "hbond_coverage": _hbond_coverage,
    "weighted_pos": _weighted_pos,
    "environment_coverage": _environment_coverage,
    "nonlinear_coupling": _nonlinear_coupling, "rotamer": _rotamer,
}
POTENTIALS = {"dist_spring", "angle_spring", "dihedral_spring",
              "backbone_pairs", "rama_map_pot", "hbond_energy",
              "nonlinear_coupling", "rotamer"}


def _tensor(v, device, dtype):
    if isinstance(v, (bool, int, float, str)):
        return v
    a = np.asarray(v)
    if a.dtype.kind == "f":
        return torch.tensor(a, dtype=dtype, device=device)
    if a.dtype.kind in "iu":
        return torch.tensor(a.astype(np.int64), device=device)
    return torch.tensor(a, device=device)


class ForceField:
    """The bundle's node graph, evaluated plainly in `dtype`.  `tol` and
    `max_iter` are the rotamer solve's (the bundle's own tolerance is the
    program's stopping rule; the reference converges further)."""

    def __init__(self, nodes, device, dtype=torch.float64, tol=1e-10,
                 max_iter=5000):
        unknown = {n["type"] for n in nodes} - set(COMPUTE)
        if unknown:
            raise ValueError(f"no reference for node types {sorted(unknown)}")
        self.device, self.dtype = torch.device(device), dtype
        # a lower precision stops where its rounding does
        self.tol = max(tol, 10 * torch.finfo(dtype).eps)
        self.max_iter = max_iter
        placed, order, rest = {"pos"}, [], list(nodes)
        while rest:
            ready = [n for n in rest if all(a in placed for a in n["args"])]
            if not ready:
                raise ValueError("unsatisfiable node dependencies")
            for n in ready:
                order.append(n)
                placed.add(n["name"])
                rest.remove(n)
        self.nodes = order
        self.consts = {n["name"]: {k: _tensor(v, device, dtype)
                                   for k, v in n["consts"].items()}
                       for n in order}
        self.params = {n["name"]: {k: _tensor(v, device, dtype)
                                   for k, v in n["params"].items()}
                       for n in order}

    def outputs(self, pos, params=None, needed=None):
        """Every node's output at pos (B, n_atom, 3), the potentials' (B,)
        energies included; only the nodes `needed` and their inputs if
        given."""
        params = self.params if params is None else params
        keep = None
        if needed is not None:
            keep = set(needed)
            for n in reversed(self.nodes):
                if n["name"] in keep:
                    keep.update(n["args"])
        out = {"pos": pos.to(self.dtype)}
        for n in self.nodes:
            name = n["name"]
            if keep is not None and name not in keep:
                continue
            args = [out[a] for a in n["args"]]
            if n["type"] == "rotamer":
                out[name] = _rotamer(self.consts[name], params[name], args,
                                     self.tol, self.max_iter)
            else:
                out[name] = COMPUTE[n["type"]](self.consts[name],
                                               params[name], args)
        return out

    def energy(self, pos, params=None):
        out = self.outputs(pos, params)
        return sum(out[n["name"]] for n in self.nodes
                   if n["type"] in POTENTIALS)

    def gradient(self, pos, params=None):
        """dU/dpos (B, n_atom, 3) in the force field's dtype."""
        with torch.enable_grad():
            x = pos.detach().to(self.dtype).requires_grad_(True)
            (g,) = torch.autograd.grad(self.energy(x, params).sum(), x)
        return g
