"""Burial / environment chain (port of upside_md_tpu/nodes/env.py;
reference src/environment.cpp).

* environment_coverage: direction-weighted burial of each CB against the
  Boltzmann-weighted sidechain beads (radial x angular compact sigmoids);
  on the main path it is the env band of the fused pair block.
* weighted_pos: (x, y, z, exp(-E)) of each bead.
* uniform_transform: a clamped-spline transform of a scalar signal.
* linear_coupling_uniform / linear_coupling_with_inactivation: per-type
  linear energies of a signal, the second gated by (1 - another)^2.
* nonlinear_coupling: per-restype clamped-spline energy of burial.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.pairs import sequence_exclusion_mask
from ..ops.sigmoid import compact_sigmoid
from ..ops.spline import eval_clamped_bspline
from .base import flat_param, register_node, rows, type_pairs


def _environment_coverage(c, p, inputs, ctx):
    if ctx.node_name in ctx.fused:          # fused pair block env band
        return ctx.fused[ctx.node_name]
    cb = inputs[0][:, c["index1"]]                     # (B, n1, 6)
    sc = inputs[1][:, c["index2"]]                     # (B, n2, 4)
    prm = type_pairs(p["interaction_param"], c["type1"], c["type2"],
                     "interaction_param" in ctx.stacked)
    r0, r_sharp, dot0, dot_sharp = prm.unbind(-1)
    d = sc[..., None, :, 0:3] - cb[..., :, None, 0:3]
    dist2 = (d * d).sum(-1)
    cutoff = r0 + 1.0 / r_sharp
    mask = sequence_exclusion_mask(c["id1"], c["id2"], 2) \
        & (dist2 < cutoff * cutoff)
    inv_dist = 1.0 / torch.sqrt(torch.where(mask, dist2,
                                            torch.ones_like(dist2)))
    dp = inv_dist * (d * cb[..., :, None, 3:6]).sum(-1)
    radial, _ = compact_sigmoid(dist2 * inv_dist - r0, r_sharp)
    angular, _ = compact_sigmoid(dot0 - dp, dot_sharp)
    score = torch.where(mask, sc[..., None, :, 3] * radial * angular,
                        torch.zeros_like(dist2))
    return score.sum(-1).unsqueeze(-1)


def _weighted_pos(c, p, inputs, ctx):
    pos = inputs[0][:, c["index_pos"], 0:3]
    w = torch.exp(-inputs[1][:, c["index_weight"], 0:1])
    return torch.cat([pos, w], dim=-1)


def _uniform_transform(c, p, inputs, ctx):
    def rep(k):
        # a leaf stacked over replicas, (B, ...), against the (B, n) signal
        v = p[k]
        return v.reshape(v.shape[:1] + (1,) + v.shape[1:]) \
            if k in ctx.stacked else v
    x = (inputs[0][..., 0] - rep("spline_offset")) * rep("spline_inv_dx")
    v, _ = eval_clamped_bspline(rep("bspline_coeff"), x)
    return v.unsqueeze(-1)


def _ut_get_param(c, p):
    """[offset, inv_dx, coeffs...] in float32 (env.py:86-89)."""
    return np.concatenate([
        p["spline_offset"].detach().cpu().numpy().reshape(1),
        p["spline_inv_dx"].detach().cpu().numpy().reshape(1),
        p["bspline_coeff"].detach().cpu().numpy().ravel()]
    ).astype(np.float32)


def _ut_set_param(c, p, flat):
    flat = np.asarray(flat, np.float32)
    t = p["bspline_coeff"]

    def tensor(a):
        return torch.as_tensor(a, dtype=t.dtype, device=t.device)
    return {"spline_offset": tensor(flat[0]), "spline_inv_dx": tensor(flat[1]),
            "bspline_coeff": tensor(flat[2:])}


def _linear_coupling(with_inactivation):
    def compute(c, p, inputs, ctx):
        coup = rows(p["couplings"], c["coupling_types"],
                    "couplings" in ctx.stacked)
        e = coup * inputs[0][..., 0]
        if with_inactivation:
            e = e * (1.0 - inputs[1][..., c["inactivation_dim"]]) ** 2
        return e.sum(-1)
    return compute


def _nonlinear_coupling(c, p, inputs, ctx):
    coeff = rows(p["coeff"], c["coupling_types"],    # ([B,] n, n_coeff)
                 "coeff" in ctx.stacked)
    x = (inputs[0][..., 0] - c["spline_offset"]) * c["spline_inv_dx"]
    v, _ = eval_clamped_bspline(coeff, x)
    return v.sum(-1)


environment_coverage = register_node("environment_coverage", False,
                                     _environment_coverage)
weighted_pos = register_node("weighted_pos", False, _weighted_pos)
uniform_transform = register_node("uniform_transform", False,
                                  _uniform_transform,
                                  get_param=_ut_get_param,
                                  set_param=_ut_set_param)
_get_couplings, _set_couplings = flat_param("couplings", np.float32)
linear_coupling_uniform = register_node(
    "linear_coupling_uniform", True, _linear_coupling(False),
    get_param=_get_couplings, set_param=_set_couplings)
linear_coupling_with_inactivation = register_node(
    "linear_coupling_with_inactivation", True, _linear_coupling(True),
    get_param=_get_couplings, set_param=_set_couplings)
_get_coeff, _set_coeff = flat_param("coeff", np.float32)
nonlinear_coupling = register_node("nonlinear_coupling", True,
                                   _nonlinear_coupling, get_param=_get_coeff,
                                   set_param=_set_coeff)
