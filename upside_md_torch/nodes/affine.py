"""Rigid-body alignment node (port of upside_md_tpu/nodes/affine.py;
reference src/eig.cpp `affine_alignment`).  Output width 7: translation
then quaternion."""

from __future__ import annotations

import torch

from ..ops.geometry import rigid_alignment
from .base import register_node


def _affine_alignment(c, p, inputs, ctx):
    atoms = inputs[0][:, c["atoms"]]                   # (B, n_res, 3, 3)
    center, quat = rigid_alignment(atoms, c["ref_geom"])
    return torch.cat([center, quat], dim=-1)


affine_alignment = register_node("affine_alignment", False,
                                 _affine_alignment)
