"""Distance-spline pair potentials (port of upside_md_tpu/nodes/radial.py;
reference src/sidechain_radial.cpp).

* radial: the symmetric CB-CB clamped-spline potential with per-type-pair
  tables, a row [inv_dx, 16 knots]; pairs at sequence separation above 2,
  each unordered pair once (the upper triangle).
* hbond_sc_radial: the asymmetric variant between two coordinate sets.
* contact: an explicit contact list with compact sigmoids.

Plain PyTorch, as the reference is XLA.  radial's grid is (B, n, n) over
the CB probes, dense up to NEIGHBOR_LIST_THRESHOLD of them; above, each
probe's min(n, NEIGHBOR_K) nearest partners inside the largest cutoff of
the table (`ops/pairs.neighbor_list`, as the rotamer grid and the
coverages take above 1,024 beads): exact while no probe has more
partners, the farthest dropped otherwise.  The partners' positions come
through `ops/pairs.gather_rows`, whose backward sums in a fixed order.
The threshold is read at call time.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from ..ops.pairs import (gather_rows, neighbor_list, sequence_exclusion_mask,
                         type_members)
from ..ops.sigmoid import compact_sigmoid
from ..ops.spline import eval_clamped_bspline
from .base import (flat_param, per_slot, register_node, to_tensor,
                   type_pairs)

N_KNOT_RADIAL = 16            # sidechain_radial.cpp:30
NEIGHBOR_LIST_THRESHOLD = 1024
NEIGHBOR_K = 128


def radial_energy(p, disp, mask):
    """Pair energies (..., n1, n2) from rows p (..., 1 + n_knot) and
    displacements disp (..., 3): the spline of |d| * inv_dx with the
    reference's 1e-7 guard (sidechain_radial.cpp:47-61), 0 outside `mask`
    and beyond the spline's cutoff."""
    inv_dx = p[..., 0]
    dist2 = (disp * disp).sum(-1)
    inv_dist = 1.0 / torch.sqrt(torch.where(mask, dist2 + 1e-7,
                                            torch.ones_like(dist2)))
    coord = dist2 * inv_dist * inv_dx
    n_knot = p.shape[-1] - 1
    cutoff = (n_knot - 2 - 1e-6) / inv_dx
    live = mask & (dist2 < cutoff * cutoff)
    en, _ = eval_clamped_bspline(p[..., 1:], coord)
    return torch.where(live, en, torch.zeros_like(en))


def _prepare_radial(c, device, dtype):
    out = {k: to_tensor(v, device, dtype) for k, v in c.items()}
    ids = out["id"]
    out["pair_mask"] = sequence_exclusion_mask(ids, ids, 2) & torch.ones(
        len(ids), len(ids), dtype=torch.bool, device=device).triu(1)
    return out


def _radial_dense(c, table, x, stacked):
    p = type_pairs(table, c["type"], c["type"], stacked)
    disp = x[:, :, None, :] - x[:, None, :, :]
    return radial_energy(p, disp, c["pair_mask"]).sum((-1, -2))


def _radial_neighbours(c, table, x, plain=False):
    """The energy (B,) on the neighbour list, spanned and counted as the
    list `radial` (`tracing.py`)."""
    def compute():
        # the largest cutoff of the table bounds every pair's (a tensor:
        # no host sync)
        reach = (table.shape[-1] - 3 - 1e-6) / table[..., 0].detach().min()
        idx, kept = neighbor_list(x, x, reach * reach, c["pair_mask"],
                                  min(x.shape[1], NEIGHBOR_K))
        t = c["type"]
        p = table[t[None, :, None], t[idx]]              # (B, n, K, 17)
        disp = x[:, :, None, :] - gather_rows(x, idx, kept, plain)
        return radial_energy(p, disp, kept).sum((-1, -2))
    return tracing.neighbour_list_span("radial", compute)


def _radial(c, p, inputs, ctx):
    x = inputs[0][:, c["index"], 0:3]
    table = p["interaction_param"]
    stacked = "interaction_param" in ctx.stacked
    if x.shape[1] <= NEIGHBOR_LIST_THRESHOLD:
        return _radial_dense(c, table, x, stacked)
    if stacked:
        return per_slot(
            lambda tab, xs: _radial_neighbours(c, tab, xs, ctx.plain),
            table, x)
    return _radial_neighbours(c, table, x, ctx.plain)


def _hbond_sc_radial(c, p, inputs, ctx):
    x1 = inputs[0][:, c["index1"], 0:3]
    x2 = inputs[1][:, c["index2"], 0:3]
    prm = type_pairs(p["interaction_param"], c["type1"], c["type2"],
                     "interaction_param" in ctx.stacked)
    mask = sequence_exclusion_mask(c["id1"], c["id2"], 2)
    disp = x1[:, :, None, :] - x2[:, None, :, :]
    return radial_energy(prm, disp, mask).sum((-1, -2))


def _contact_values(c, p, x):
    """(B, n_contact) energy * compact_sigmoid(|x_i - x_j| - distance,
    1/width) (sidechain_radial.cpp:186-203)."""
    ids = c["id"]
    disp = x[:, ids[:, 0], 0:3] - x[:, ids[:, 1], 0:3]
    dist = torch.sqrt((disp * disp).sum(-1))
    v, _ = compact_sigmoid(dist - p["distance"], 1.0 / p["width"])
    return p["energy"] * v


def _contact(c, p, inputs, ctx):
    return _contact_values(c, p, inputs[0]).sum(-1)


def _prepare_contact(c, device, dtype):
    """The contact list, and each bead's contact ends (`bead_contacts`,
    (max id + 1, m)): indices into [the first ends' energies, the second
    ends', a zero], in that order, padded with the zero's index."""
    out = {k: to_tensor(v, device, dtype) for k, v in c.items()}
    ends = np.asarray(c["id"]).T.reshape(-1)
    out["bead_contacts"] = type_members(
        ends, int(ends.max()) + 1 if len(ends) else 0).to(device)
    return out


def contact_energy_per_bead(consts, params, inputs):
    """Per-bead contact energy (B, n_bead), half of each pair's energy on
    both of its beads: the reference's 'contact_energy' stream
    (sidechain_radial.cpp:171-183).  Each bead gathers its contacts'
    halves (`bead_contacts`) and sums them in a fixed order: an index_add
    would sum with float atomics on the card, in an order that varies run
    to run."""
    x = inputs[0]
    en = 0.5 * _contact_values(consts, params, x)
    halves = torch.nn.functional.pad(torch.cat([en, en], -1), (0, 1))
    per = halves[:, consts["bead_contacts"]].sum(-1)
    return torch.nn.functional.pad(per, (0, x.shape[1] - per.shape[1]))


_get_table, _set_table = flat_param("interaction_param")
radial = register_node("radial", True, _radial, prepare=_prepare_radial,
                       get_param=_get_table, set_param=_set_table)
hbond_sc_radial = register_node("hbond_sc_radial", True, _hbond_sc_radial,
                                get_param=_get_table, set_param=_set_table)
contact = register_node("contact", True, _contact,
                        prepare=_prepare_contact)
