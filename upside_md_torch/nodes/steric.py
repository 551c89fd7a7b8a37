"""Backbone steric repulsion (port of upside_md_tpu/nodes/steric.py;
reference src/backbone_steric.cpp).  Up to four frame-placed atoms per
residue; residue pairs more than one apart repel through a compact sigmoid
of squared distance that is exactly zero beyond r^2 = 9.3."""

from __future__ import annotations

import torch

from ..ops.geometry import quat_to_rot, rotate_vec
from ..ops.sigmoid import compact_sigmoid
from .base import register_node, to_tensor

ENERGY_SCALE = 4.0
WALL2 = 3.0 * 3.0
SHARPNESS = 1.0 / (3.0 * 0.10)  # 1/(wall*width), backbone_steric.cpp:22-27


def _prepare(c, device, dtype):
    out = {k: to_tensor(v, device, dtype) for k, v in c.items()}
    # static atom-pair mask: residue ids more than one apart, each
    # unordered pair once, both atoms present
    rid = out["id"].repeat_interleave(4)
    valid = out["atom_mask"].reshape(-1)
    d = rid[:, None] - rid[None, :]
    out["pair_mask"] = (d < -1) & valid[:, None] & valid[None, :]
    return out


def _backbone_pairs(c, p, inputs, ctx):
    affine = inputs[0][:, c["id"]]                     # (B, n_res, 7)
    R = quat_to_rot(affine[..., 3:7])
    atoms = rotate_vec(R.unsqueeze(-3), c["ref_pos"]) \
        + affine[..., None, 0:3]                       # (B, n_res, 4, 3)
    ax = atoms.reshape(atoms.shape[0], -1, 3)
    d = ax.unsqueeze(1) - ax.unsqueeze(2)
    r2 = (d * d).sum(-1)
    v, _ = compact_sigmoid(r2 - WALL2, SHARPNESS)
    return ENERGY_SCALE * torch.where(c["pair_mask"], v,
                                      torch.zeros_like(v)).sum((-1, -2))


backbone_pairs = register_node("backbone_pairs", True, _backbone_pairs,
                               prepare=_prepare)
