"""Backbone hydrogen bonds (port of upside_md_tpu/nodes/hbond.py;
reference src/hbond.cpp).

* infer_H_O: virtual amide H / carbonyl O sites and bond directions.
* protein_hbond: per-virtual hbond probability from the donor x acceptor
  grid; output width 7 (site, direction, probability).
* hbond_energy: E * sum of the probabilities.
* hbond_coverage (also the hydrophobe coverage): per-bead coverage of the
  row sites weighted by (1 - s)^2.  Up to 512 beads it comes out of the
  fused pair block (nodes/fusion.py); above, each node runs K4, the
  weighted column sums of the pair spline (hbond.py:124-166 of the JAX
  package), and above COVERAGE_NL_THRESHOLD columns the neighbour list
  (hbond.py:139-148): each row's COVERAGE_NEIGHBOR_K nearest in-cutoff
  columns, their weighted values summed by column.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from ..ops.pairs import (quadspline_coverage_nl, quadspline_family,
                         scatter_rows)
from ..ops.quadspline import PairSpline, quadspline_colsum
from .base import per_slot, register_node, to_tensor, type_pairs

RADIAL_CUTOFF2 = 3.5 * 3.5  # hbond.cpp:124
# above this many columns the coverage takes the fixed-K neighbour list
# (hbond.py:32-33 of the JAX package); read at call time
COVERAGE_NL_THRESHOLD = 1024
COVERAGE_NEIGHBOR_K = 96


def _unit(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _infer_h_o(c, p, inputs, ctx):
    pos = inputs[0]
    ids = c["id"]
    curr = pos[:, ids[:, 1]]
    direction = -_unit(_unit(pos[:, ids[:, 0]] - curr)
                       + _unit(pos[:, ids[:, 2]] - curr))
    place = curr + c["bond_length"][:, None] * direction
    return torch.cat([place, direction], dim=-1)


def hbond_pair_strength(p, H, rHN, O, rOC):
    """Per-pair hbond strength on the (..., n_donor, n_acceptor) grid.
    p (nd, na, 8): [inner_barrier, inv_inner_width, outer_barrier,
    inv_outer_width, wall_dp, inv_dp_width, 0, 0] (hbond.cpp:153-230)."""
    HO = H.unsqueeze(-2) - O.unsqueeze(-3)
    raw2 = (HO * HO).sum(-1)
    mag2 = raw2 + 1e-6
    inv_mag = 1.0 / torch.sqrt(mag2)
    magHO = mag2 * inv_mag
    rHO = HO * inv_mag.unsqueeze(-1)
    dotHOC = (rHO * rOC.unsqueeze(-3)).sum(-1)
    dotOHN = -(rHO * rHN.unsqueeze(-2)).sum(-1)
    # the reference 'sigmoid' is the increasing logistic 1/(1+exp(-x))
    radial = torch.sigmoid((p[..., 2] - magHO) * p[..., 3]) * \
        torch.sigmoid((magHO - p[..., 0]) * p[..., 1])
    ang1 = torch.sigmoid((dotHOC - p[..., 4]) * p[..., 5])
    ang2 = torch.sigmoid((dotOHN - p[..., 4]) * p[..., 5])
    within = (dotHOC > 0.0) & (dotOHN > 0.0) & (raw2 < RADIAL_CUTOFF2)
    return torch.where(within, radial * ang1 * ang2, torch.zeros_like(raw2))


def _protein_hbond(c, p, inputs, ctx):
    ho = inputs[0]
    don = ho[:, c["index1"]]
    acc = ho[:, c["index2"]]
    table = type_pairs(p["interaction_param"], c["type1"], c["type2"],
                       "interaction_param" in ctx.stacked)
    hb = hbond_pair_strength(table, don[..., 0:3], don[..., 3:6],
                             acc[..., 0:3], acc[..., 3:6])
    # -log(1-hb), value capped at 100 and the argument floored at 1e-5
    # like the reference (hbond.cpp:221-223)
    hb_log = torch.where(hb >= 1.0, torch.full_like(hb, 100.0),
                         -torch.log(torch.clamp(1.0 - hb, min=1e-5)))
    hb_prob = 1.0 - torch.exp(-torch.cat([hb_log.sum(-1), hb_log.sum(-2)],
                                         dim=-1))
    base = torch.cat([don, acc], dim=-2)
    return torch.cat([base, hb_prob.unsqueeze(-1)], dim=-1)


def _hbond_energy(c, p, inputs, ctx):
    return p["protein_hbond_energy"] * inputs[0][..., 6].sum(-1)


def _prepare_coverage(c, device, dtype):
    """The consts as tensors, plus K4's static operands: row and column
    types and the sequence exclusion |id1 - id2| > 2."""
    out = {k: to_tensor(v, device, dtype) for k, v in c.items()}
    sep = np.asarray(c["id1"])[:, None] - np.asarray(c["id2"])[None, :]
    out["spline"] = PairSpline(c["type1"], c["type2"], np.abs(sep) > 2,
                               device)
    return out


def _hbond_coverage(c, p, inputs, ctx):
    if ctx.node_name in ctx.fused:          # fused pair block result
        return ctx.fused[ctx.node_name]
    hb_nodes = inputs[0][:, c["index1"]]
    sc = inputs[1][:, c["index2"]]
    prefactor = (1.0 - hb_nodes[..., 6]) ** 2

    def colsum(table, x1, x2, w1):
        if x2.shape[1] > COVERAGE_NL_THRESHOLD:
            return coverage_nl(c, table, x1, x2, w1, ctx.plain,
                               ctx.node_name)
        return quadspline_colsum(c["spline"], table, x1, x2, w1, ctx.plain)

    args = (p["interaction_param"], hb_nodes[..., :6], sc[..., :6],
            prefactor)
    cov = per_slot(colsum, *args) if "interaction_param" in ctx.stacked \
        else colsum(*args)
    return cov.unsqueeze(-1)


def coverage_nl(c, table, x1, x2, w1, plain=False, site="hbond_coverage"):
    """The coverage (B, n2) from the neighbour list (hbond.py:139-148):
    w1[i] times the pair value at each row's COVERAGE_NEIGHBOR_K nearest
    in-cutoff columns, summed by column.  The values go back on the dense
    (B, n1, n2) grid (`scatter_rows`: a row's kept columns are distinct,
    so no two values meet) and each column sums its rows in a fixed
    order; a scatter_add into the columns would sum with float atomics on
    the card, in an order that varies run to run.  Spanned and counted as
    the list `site`, the coverage node's name (`tracing.py`)."""
    ka, k, dx = quadspline_family(table.shape[-1])

    def compute():
        cov, idx, mask = quadspline_coverage_nl(
            table, c["type1"], c["type2"], x1[..., 0:3], x1[..., 3:6],
            x2[..., 0:3], x2[..., 3:6], ka, k, 1.0 / dx,
            c["spline"].mask.bool(), COVERAGE_NEIGHBOR_K, plain=plain,
            spline=c["spline"])
        return scatter_rows(w1[..., None] * cov, idx, mask,
                            x2.shape[1]).sum(1)
    return tracing.neighbour_list_span(site, compute)


infer_H_O = register_node("infer_H_O", False, _infer_h_o)
protein_hbond = register_node("protein_hbond", False, _protein_hbond)
def _energy_get_param(c, p):
    return np.asarray([float(p["protein_hbond_energy"])], np.float32)


def _energy_set_param(c, p, flat):
    t = p["protein_hbond_energy"]
    return {"protein_hbond_energy": torch.as_tensor(
        float(flat[0]), dtype=t.dtype, device=t.device)}


hbond_energy = register_node("hbond_energy", True, _hbond_energy,
                             get_param=_energy_get_param,
                             set_param=_energy_set_param)
hbond_coverage = register_node("hbond_coverage", False, _hbond_coverage,
                               prepare=_prepare_coverage)
