"""Pair computations (port of upside_md_tpu/ops/pairs.py): masks, the
spline family of a table, the dense pair spline through K5, and the
fixed-K neighbour list that the rotamer grid and the coverage nodes take
above 1,024 beads or columns.

The neighbour list is plain PyTorch, as the reference is XLA there: no
Pallas body exists for it.  Every array carries the replica axis first,
(B, n1, K); tables and static masks are shared across replicas.
"""

from __future__ import annotations

import torch

from .spline import bspline_window_weights

# score of a pair outside the mask or the cutoff (ops/pairs.py:75)
FAR = 1e30


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


def pair_coverage(table, t1, t2, feats1, feats2, base_mask, ka, k, dx):
    """Dense masked pair-spline values (..., n1, n2), cut off at
    (k-2)*dx: `pair_coverage` of the JAX package (ops/pairs.py:134),
    computed by K5 (`ops/quadspline.quadspline`: the kernel on CUDA
    tensors, its plain version on CPU ones).  The nodes call K5 with their
    call sites' statics kept in their consts; this builds them per call."""
    from .quadspline import PairSpline, quadspline
    if quadspline_family(table.shape[-1]) != (ka, k, dx):
        raise ValueError(f"pair_coverage: table of {table.shape[-1]} "
                         f"parameters is not the family {(ka, k, dx)}")
    ps = PairSpline(t1.cpu().numpy(), t2.cpu().numpy(),
                    base_mask.cpu().numpy(), feats1.device)
    lead = feats1.dim() == 2
    x1, x2 = (f[None] if lead else f for f in (feats1, feats2))
    out = quadspline(ps, table, x1[..., :6], x2[..., :6])
    return out[0] if lead else out


def batch_rows(x, idx):
    """x (B, n, w) at the per-replica row indices idx (B, ...): (B, ...,
    w).  One index_select over the flattened replicas, whose backward is an
    index_add."""
    B, n = x.shape[:2]
    flat = (idx + n * torch.arange(B, device=idx.device).reshape(
        (B,) + (1,) * (idx.dim() - 1))).reshape(-1)
    return x.reshape(B * n, -1).index_select(0, flat).reshape(
        idx.shape + x.shape[2:])


def neighbor_list(pos1, pos2, cutoff2, base_mask, K):
    """Fixed-K nearest-neighbour list over a masked pair grid
    (ops/pairs.py:63-80): for each row of pos1 (B, n1, 3) the K nearest
    columns of pos2 (B, n2, 3) where base_mask (n1, n2) holds and the
    squared distance is below cutoff2.  A row with more than K such
    partners drops the farthest, as the reference does.  Returns (idx (B,
    n1, K) int64, mask (B, n1, K) bool); the order within a row is not
    defined."""
    with torch.no_grad():
        d2, ok = _in_cutoff(pos1, pos2, cutoff2, base_mask)
        near, idx = torch.topk(torch.where(ok, d2, torch.full_like(d2, FAR)),
                               K, dim=-1, largest=False)
    return idx, near < FAR


def partner_counts(pos1, pos2, cutoff2, base_mask):
    """(B, n1) in-cutoff partners of each row of the neighbour list's
    selection: above K the list drops the farthest."""
    with torch.no_grad():
        return _in_cutoff(pos1, pos2, cutoff2, base_mask)[1].sum(-1)


def _in_cutoff(pos1, pos2, cutoff2, base_mask):
    """Squared distances (B, n1, n2) and the pairs the list may keep."""
    d2 = sum((pos2[:, None, :, a] - pos1[:, :, None, a]) ** 2
             for a in range(3))
    return d2, base_mask & (d2 < cutoff2)


def quadspline_coverage_nl(p_table, t1, t2, pos1, dir1, pos2, dir2,
                           n_knot_angular, n_knot, inv_dx, base_mask, K):
    """The pair spline on the neighbour list (ops/pairs.py:82-121): the
    values of the dense pair spline at each row's K nearest in-cutoff
    columns.  p_table (n_t1, n_t2, m) is shared; t1 (n1,), t2 (n2,) the
    row and column types; pos and dir (B, n, 3).  Returns (values (B, n1,
    K), idx, mask) with 0 where the mask is off.  Differentiable in the
    positions, directions and table by autograd, as the reference is."""
    ka, k = n_knot_angular, n_knot
    cutoff = (k - 2 - 1e-6) / inv_dx
    idx, mask = neighbor_list(pos1, pos2, cutoff * cutoff, base_mask, K)
    p2, d2 = batch_rows(pos2, idx), batch_rows(dir2, idx)     # (B, n1, K, 3)
    p = p_table[t1[None, :, None], t2[idx]]                    # (B, n1, K, m)

    disp = p2 - pos1[:, :, None, :]
    dist2 = (disp * disp).sum(-1)
    # 1/sqrt that never sees a slot outside the mask (safe_inv_dist, :39)
    inv_dist = 1.0 / torch.sqrt(torch.where(mask, dist2,
                                            torch.ones_like(dist2)))
    dist_coord = dist2 * inv_dist * inv_dx
    u = disp * inv_dist[..., None]
    cos1 = (dir1[:, :, None, :] * u).sum(-1)
    cos2 = -(d2 * u).sum(-1)
    inv_dtheta = (ka - 3) / 2.0

    def seg_eval(x, lo, hi, clamped):
        W = bspline_window_weights(x, hi - lo, clamped)
        return (W * p[..., lo:hi]).sum(-1)

    a1 = seg_eval((cos1 + 1.0) * inv_dtheta + 1.0, 0, ka, False)
    a2 = seg_eval((cos2 + 1.0) * inv_dtheta + 1.0, ka, 2 * ka, False)
    wide = seg_eval(dist_coord, 2 * ka, 2 * ka + k, True)
    narrow = seg_eval(dist_coord, 2 * ka + k, 2 * ka + 2 * k, True)
    cov = torch.where(mask, wide + a1 * a2 * narrow, torch.zeros_like(wide))
    return cov, idx, mask


def scatter_rows(values, idx, mask, n2):
    """Neighbour values (B, n1, K) back on the dense (B, n1, n2) grid
    (ops/pairs.py:124-131): slots off the mask go to a drop column n2,
    which is cut off.  A row's kept indices are distinct, so every kept
    value lands on its own element."""
    B, n1, _ = values.shape
    safe = torch.where(mask, idx, torch.full_like(idx, n2))
    dense = values.new_zeros((B, n1, n2 + 1)).scatter_add(
        2, safe, torch.where(mask, values, torch.zeros_like(values)))
    return dense[..., :n2]
