"""Masked dense pair computations (port of the dense subset of
upside_md_tpu/ops/pairs.py).  The neighbour-list path of the JAX package
engages only above 1024 beads and is not ported yet."""

from __future__ import annotations

import torch

from .spline import bspline_window_weights


def sequence_exclusion_mask(id1, id2, min_sep):
    """True where |id1[i] - id2[j]| > min_sep (the reference's
    acceptable_id_pair exclusion of i, i+1, i+2)."""
    d = id1[:, None] - id2[None, :]
    return (d > min_sep) | (d < -min_sep)


def quadspline_family(n_param):
    """(n_knot_angular, n_knot, dx) of a directional-bead spline table from
    its parameter count n_param = 2*ka + 2*k (src/bead_interaction.h:12-27)."""
    families = {
        2 * 8 + 2 * 9: (8, 9, 1.0),     # default: SC_SC
        2 * 8 + 2 * 7: (8, 7, 1.0),     # default: SC_BB
        2 * 15 + 2 * 16: (15, 16, 0.5),  # PARAM_7A_CUTOFF: SC_SC
        2 * 15 + 2 * 12: (15, 12, 0.5),  # PARAM_7A_CUTOFF: SC_BB
        2 * 8 + 2 * 12: (8, 12, 1.0),   # PARAM_10A_CUTOFF: SC_SC and SC_BB
    }
    if n_param not in families:
        raise ValueError(f"cannot infer quadspline family from n_param={n_param}")
    return families[n_param]


def quadspline_coverage(p, pos1, dir1, pos2, dir2, n_knot_angular, n_knot,
                        inv_dx, mask):
    """Directional bead-pair spline (reference bead_interaction.h:30-84).

    p (..., n1, n2, 2*ka + 2*k) per-pair tables; pos/dir (..., n, 3).
    Returns (..., n1, n2) = wide(r) + ang1(cos1)*ang2(cos2)*narrow(r) where
    mask holds, else 0."""
    ka, k = n_knot_angular, n_knot
    disp = pos2.unsqueeze(-3) - pos1.unsqueeze(-2)        # x2 - x1
    dist2 = (disp * disp).sum(-1)
    inv_dist = 1.0 / torch.sqrt(torch.where(mask, dist2,
                                            torch.ones_like(dist2)))
    s = dist2 * inv_dist * inv_dx
    u = disp * inv_dist.unsqueeze(-1)
    cos1 = (dir1.unsqueeze(-2) * u).sum(-1)
    cos2 = -(dir2.unsqueeze(-3) * u).sum(-1)
    inv_dtheta = (ka - 3) / 2.0

    def seg(x, lo, hi, clamped):
        return (bspline_window_weights(x, hi - lo, clamped)
                * p[..., lo:hi]).sum(-1)

    a1 = seg((cos1 + 1.0) * inv_dtheta + 1.0, 0, ka, False)
    a2 = seg((cos2 + 1.0) * inv_dtheta + 1.0, ka, 2 * ka, False)
    wide = seg(s, 2 * ka, 2 * ka + k, True)
    narrow = seg(s, 2 * ka + k, 2 * ka + 2 * k, True)
    return torch.where(mask, wide + a1 * a2 * narrow, torch.zeros_like(s))


def pair_coverage(table, t1, t2, feats1, feats2, base_mask, ka, k, dx):
    """Dense masked pair-spline values (..., n1, n2), cut off at
    (k-2)*dx.  This is the plain version of the JAX package's
    `quadspline_pallas` (ops/pallas_quadspline.py:737), whose Hopper
    kernel is not written yet: on a CUDA tensor it raises."""
    if feats1.is_cuda:
        raise NotImplementedError(
            "the unfused pair-spline kernel (quadspline_pallas) has no "
            "Hopper port yet; the fused pair block covers the main path")
    p = table[t1[:, None], t2[None, :]]
    disp = feats2[..., None, :, 0:3] - feats1[..., :, None, 0:3]
    cutoff = (k - 2 - 1e-6) * dx
    mask = base_mask & ((disp * disp).sum(-1) < cutoff * cutoff)
    return quadspline_coverage(p, feats1[..., 0:3], feats1[..., 3:6],
                               feats2[..., 0:3], feats2[..., 3:6],
                               ka, k, 1.0 / dx, mask)
