"""Springs and Ramachandran coordinates (port of the main-path subset of
upside_md_tpu/nodes/basic.py; reference src/bonds.cpp)."""

from __future__ import annotations

import torch

from ..ops.geometry import dihedral, mag, wrap_angle
from .base import register_node

DUMMY_RAMA_ANGLE = -1.3963  # -80 degrees, reference bonds.cpp:220


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


dist_spring = register_node("dist_spring", True, _dist_spring)
angle_spring = register_node("angle_spring", True, _angle_spring)
dihedral_spring = register_node("dihedral_spring", True, _dihedral_spring)
rama_coord = register_node("rama_coord", False, _rama_coord)
