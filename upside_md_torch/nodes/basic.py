"""Basic coordinate and spring nodes (port of upside_md_tpu/nodes/basic.py;
reference src/bonds.cpp): coordinate plumbing (constant, slice, concat),
springs on positions (atom_pos_spring, tension, AFM, cavity_radial,
z_flat_bottom), the bonded springs and the Ramachandran coordinates.

A parameter stacked over replicas carries a leading replica axis, which
broadcasts against the (B, n) per-element values here as it is."""

from __future__ import annotations

import torch

from ..ops.geometry import dihedral, mag, wrap_angle
from .base import flat_param, register_node

DUMMY_RAMA_ANGLE = -1.3963  # -80 degrees, reference bonds.cpp:220


# -- coordinate plumbing ------------------------------------------------

def _constant(c, p, inputs, ctx):
    """The parameter `value` (n, w) for every replica: (B, n, w)."""
    v = p["value"]
    if "value" in ctx.stacked:
        return v
    return v.expand((ctx.n_replica,) + tuple(v.shape))


def _slice(c, p, inputs, ctx):
    return inputs[0][:, c["id"]]


def _concat(c, p, inputs, ctx):
    return torch.cat(inputs, dim=1)


# -- springs on positions -----------------------------------------------

def _half_spring(k, disp):
    """0.5 * sum k |disp|^2 over the elements: (B,)."""
    return 0.5 * (k * (disp * disp).sum(-1)).sum(-1)


def _atom_pos_spring(c, p, inputs, ctx):
    # E = sum 0.5*k*|x - x0|^2  (bonds.cpp:35-48)
    return _half_spring(p["spring_const"], inputs[0][:, c["id"]] - p["x0"])


def _tension(c, p, inputs, ctx):
    # E = -sum dot(x, tension_coeff)  (bonds.cpp:75-88)
    return -(inputs[0][:, c["atom"]] * p["tension_coeff"]).sum((-1, -2))


def _afm(c, p, inputs, ctx):
    """Constant-velocity pulling: the tip moves with the force-evaluation
    counter (bonds.cpp:148-166; `ctx.n_deriv_evals`, 0 in an energy-only
    evaluation, as the JAX package's `extra.get("n_deriv_evals", 0)`)."""
    t = c.get("time_initial", 0.0) + c.get("time_step", 0.009) * \
        ctx.n_deriv_evals
    vel = p["pulling_vel"]
    tip = p["starting_tip_pos"] + vel * t
    return _half_spring(p["spring_const"], inputs[0][:, c["atom"]] - tip)


def _cavity_radial(c, p, inputs, ctx):
    # flat inside the radius, harmonic outside (bonds.cpp:350-372)
    x = inputs[0][:, c["id"]]
    r2 = (x * x).sum(-1)
    rad = p["radius"]
    out = r2 > rad * rad
    r = torch.sqrt(torch.where(out, r2, torch.ones_like(r2)))
    excess = torch.where(out, r - rad, torch.zeros_like(r2))
    return 0.5 * (p["spring_const"] * excess * excess).sum(-1)


def _z_flat_bottom(c, p, inputs, ctx):
    # flat within |z - z0| < radius, harmonic outside (bonds.cpp:407-425)
    dz = inputs[0][:, c["atom"], 2] - p["z0"]
    rad = p["radius"]
    excess = torch.where(dz > rad, dz - rad,
                         torch.where(dz < -rad, dz + rad,
                                     torch.zeros_like(dz)))
    return 0.5 * (p["spring_const"] * excess * excess).sum(-1)


def _dist_spring(c, p, inputs, ctx):
    # E = sum 0.5*k*(|x1-x2| - d0)^2  (bonds.cpp:297-318)
    x = inputs[0]
    d = mag(x[:, c["id"][:, 0]] - x[:, c["id"][:, 1]])
    return 0.5 * (p["spring_const"] * (d - p["equil_dist"]) ** 2).sum(-1)


def _angle_spring(c, p, inputs, ctx):
    # spring on the cosine of the angle at atom 3 (bonds.cpp:457-487)
    x = inputs[0]
    a3 = x[:, c["id"][:, 2]]
    x1 = x[:, c["id"][:, 0]] - a3
    x2 = x[:, c["id"][:, 1]] - a3
    dp = (x1 * x2).sum(-1) / (mag(x1) * mag(x2))
    return 0.5 * (p["spring_const"] * (dp - p["equil_dp"]) ** 2).sum(-1)


def _dihedral_spring(c, p, inputs, ctx):
    # 0.5*k*wrap(dihedral - equil)^2  (bonds.cpp:519-545)
    x = inputs[0]
    ids = c["id"]
    dih = dihedral(x[:, ids[:, 0]], x[:, ids[:, 1]], x[:, ids[:, 2]],
                   x[:, ids[:, 3]])
    disp = wrap_angle(dih - p["equil_dihedral"])
    return 0.5 * (p["spring_const"] * disp * disp).sum(-1)


def _rama_coord(c, p, inputs, ctx):
    """(phi, psi) per residue from [prevC, N, CA, C, nextN].  Terminal
    dummy angles are the constant -80 degrees; dummy atom slots get a
    non-collinear stand-in so the discarded branch has a finite gradient
    (bonds.cpp:190-226)."""
    x = inputs[0]
    a = x[:, c["id"]]                                  # (B, n_res, 5, 3)
    dummy = c["dummy"]
    safe0 = a[:, :, 1] + a.new_tensor([1.3, 0.7, 0.9])
    safe4 = a[:, :, 3] + a.new_tensor([0.9, 1.3, 0.7])
    a0 = torch.where(dummy[:, 0:1], safe0, a[:, :, 0])
    a4 = torch.where(dummy[:, 1:2], safe4, a[:, :, 4])
    phi = dihedral(a0, a[:, :, 1], a[:, :, 2], a[:, :, 3])
    psi = dihedral(a[:, :, 1], a[:, :, 2], a[:, :, 3], a4)
    fill = torch.full_like(phi, DUMMY_RAMA_ANGLE)
    phi = torch.where(dummy[:, 0], fill, phi)
    psi = torch.where(dummy[:, 1], fill, psi)
    return torch.stack([phi, psi], dim=-1)


_get_value, _set_value = flat_param("value", None)
constant = register_node("constant", False, _constant, get_param=_get_value,
                         set_param=_set_value)
slice_node = register_node("slice", False, _slice)
concat = register_node("concat", False, _concat)
atom_pos_spring = register_node("atom_pos_spring", True, _atom_pos_spring)
tension = register_node("tension", True, _tension)
afm = register_node("AFM", True, _afm)
cavity_radial = register_node("cavity_radial", True, _cavity_radial)
z_flat_bottom = register_node("z_flat_bottom", True, _z_flat_bottom)
dist_spring = register_node("dist_spring", True, _dist_spring)
angle_spring = register_node("angle_spring", True, _angle_spring)
dihedral_spring = register_node("dihedral_spring", True, _dihedral_spring)
rama_coord = register_node("rama_coord", False, _rama_coord)
