"""Membrane potential (port of upside_md_tpu/nodes/membrane.py; reference
src/membrane_potential.cpp).

A per-restype z-profile spline on the CB position, gated by a compact
sigmoid of burial (the environment coverage), plus a z-profile penalty on
unpaired hbond donors and acceptors weighted by (1 - hbond probability)^2.
The bundle carries the fitted profiles (`cb_coeff`, `uhb_coeff`); on the
fused path the coverage it reads is the env band of the fused pair block,
the same output and cotangent path the burial coupling reads.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.sigmoid import compact_sigmoid
from ..ops.spline import eval_clamped_interp, fit_clamped_interp_bspline
from .base import register_node, rows


def _membrane_potential(c, p, inputs, ctx):
    cb_pos, env_cov, hbond = inputs
    restype = c["residue_type"]
    cb_z = cb_pos[:, c["cb_index"], 2]
    cb_coord = (cb_z + c["cb_z_shift"]) * c["cb_z_scale"]
    cb_en, _ = eval_clamped_interp(
        rows(p["cb_coeff"], restype, "cb_coeff" in ctx.stacked), cb_coord)
    cov = env_cov[:, c["env_index"], 0]
    cover, _ = compact_sigmoid(cov - c["cov_midpoint"][restype],
                               c["cov_sharpness"][restype])
    pot = (cb_en * cover).sum(-1)

    # unpaired-hbond z penalty: layer 0 for donors, 1 for acceptors
    layer = (torch.arange(hbond.shape[1], device=hbond.device)
             >= c["n_donor"]).long()
    uhb_coord = (hbond[..., 2] + c["uhb_z_shift"]) * c["uhb_z_scale"]
    uhb_en, _ = eval_clamped_interp(
        rows(p["uhb_coeff"], layer, "uhb_coeff" in ctx.stacked), uhb_coord)
    return pot + (uhb_en * (1.0 - hbond[..., 6]) ** 2).sum(-1)


def make_membrane_params(cb_energy, uhb_energy):
    """The raw cb and uhb z-profiles -> their clamped interpolating fits
    in float32 (fitted in float64, membrane.py:43-53)."""
    return {name: fit_clamped_interp_bspline(
        np.asarray(raw, np.float64)).astype(np.float32)
        for name, raw in (("cb_coeff", cb_energy), ("uhb_coeff", uhb_energy))}


membrane_potential = register_node("membrane_potential", True,
                                   _membrane_potential)
