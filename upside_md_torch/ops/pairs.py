"""Masked dense pair computations (port of the dense subset of
upside_md_tpu/ops/pairs.py).  The neighbour-list path of the JAX package
engages only above 1024 beads and is not ported yet; the pair-spline
kernels live in ops/quadspline.py."""

from __future__ import annotations


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
