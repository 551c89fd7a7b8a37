"""Pair computations (port of upside_md_tpu/ops/pairs.py): masks, the
spline family of a table, the dense pair spline through K5, and the
fixed-K neighbour list that the rotamer grid and the coverage nodes take
above 1,024 beads or columns.

The list's build (`neighbor_list`: distances and `topk`) is plain
PyTorch, as the reference is XLA there.  The pair spline on a built list
(`quadspline_coverage_nl`) is two kernels of the port's own on the card,
`nlist_spline_fwd` and `nlist_spline_bwd` (csrc/nlist_spline.cu), with
the plain version `quadspline_coverage_nl_plain` for CPU tensors and
`plain=True`.  The backward of a list's row gather (`gather_rows`; also
the kernels' column sums) is `gather_rows_bwd` (csrc/gather_rows.cu): a
sum in a fixed order where `index_select`'s backward added with float
atomics.  The nodes run each list inside `tracing.neighbour_list_span`;
its build is spanned `nlist.build`.  Every array carries the replica axis
first, (B, n1, K); tables and static masks are shared across replicas.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from . import kernels
from .fused_pair import table_cotangent
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


def gather_rows(x, idx, mask, plain=False):
    """x (B, n, w) at the per-replica row indices idx (B, ...): (B, ...,
    w), the gather of the neighbour lists.  Its backward sums each row's
    cotangent over the slots that read it in a fixed order, increasing
    slot index, with no float atomics (`gather_rows_bwd`: the kernel on a
    CUDA tensor, its plain version on a CPU one or when `plain`), so the
    gradient is the same on every run.  Slots where `mask` (idx's shape)
    is False take no cotangent: on the neighbour lists theirs is 0."""
    return _GatherRows.apply(x, idx, mask, plain)


def flat_rows(idx, n):
    """idx (B, ...) of rows of x (B, n, w) as rows of the flattened x (B
    n, w): (m,), m = idx.numel()."""
    b = torch.arange(idx.shape[0], device=idx.device).reshape(
        (-1,) + (1,) * (idx.dim() - 1))
    return (idx + n * b).reshape(-1)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, mask, plain):
        B, n = x.shape[:2]
        flat = flat_rows(idx, n)
        ctx.save_for_backward(flat, mask)
        ctx.x_shape, ctx.plain = x.shape, plain
        return x.reshape(B * n, -1).index_select(0, flat).reshape(
            idx.shape + x.shape[2:])

    @staticmethod
    def backward(ctx, g):
        flat, mask = ctx.saved_tensors
        n_rows = ctx.x_shape[0] * ctx.x_shape[1]
        order, starts = row_segments(flat, n_rows, mask)
        gx = gather_rows_bwd(g.reshape(flat.shape[0], -1), order, starts,
                             ctx.plain)
        return gx.reshape(ctx.x_shape), None, None, None


def row_segments(flat, n_rows, mask):
    """The slots (m,) sorted by their row flat (in [0, n_rows)), and each
    row's segment of that order: (order (m,), starts (n_rows + 1,)), row r
    read by the slots order[starts[r]:starts[r + 1]] in increasing slot
    order (a stable integer sort).  Slots off `mask` sort last, past
    starts[n_rows]."""
    key = torch.where(mask.reshape(-1), flat, torch.full_like(flat, n_rows))
    key, order = torch.sort(key.to(torch.int32), stable=True)
    starts = torch.searchsorted(key, torch.arange(
        n_rows + 1, dtype=torch.int32, device=key.device))
    return order, starts


def gather_rows_bwd(g, order, starts, plain=False):
    """(n_rows, w): row r's sum of g (m, w) over the slots
    order[starts[r]:starts[r + 1]], left to right from 0.  The kernel on
    CUDA tensors (`csrc/gather_rows.cu`), the plain version on CPU ones or
    when `plain`."""
    n_rows = starts.shape[0] - 1
    if plain or g.device.type != "cuda":
        return gather_rows_bwd_plain(g, order, starts)
    if (g.dtype, order.dtype, starts.dtype) != (torch.float32, torch.int64,
                                                torch.int64):
        raise TypeError(f"gather_rows_bwd: float32 cotangents and int64 "
                        f"indices, got {g.dtype}, {order.dtype}, "
                        f"{starts.dtype}")
    g = g.contiguous()
    out = g.new_empty((n_rows, g.shape[1]))
    kernels.launch("gather_rows_bwd", g, order.contiguous(),
                   starts.contiguous(), n_rows, g.shape[1], out)
    return out


def gather_rows_bwd_plain(g, order, starts):
    """`gather_rows_bwd` in PyTorch: the segments' k-th entries added to
    the running sums for k = 0, 1, ..., the kernel's additions in its
    order (rows whose segment has ended add an exact 0)."""
    n_rows = starts.shape[0] - 1
    out = g.new_zeros((n_rows, g.shape[1]))
    first, length = starts[:-1], starts[1:] - starts[:-1]
    zero = g.new_zeros(())
    with tracing.sync("gather_rows_plain"):
        longest = int(length.max())
    for k in range(longest):
        live = (length > k)[:, None]
        slot = order[(first + k).clamp(max=order.shape[0] - 1)]
        out = out + torch.where(live, g[slot], zero)
    return out


def neighbor_list(pos1, pos2, cutoff2, base_mask, K):
    """Fixed-K nearest-neighbour list over a masked pair grid
    (ops/pairs.py:63-80): for each row of pos1 (B, n1, 3) the K nearest
    columns of pos2 (B, n2, 3) where base_mask (n1, n2) holds and the
    squared distance is below cutoff2.  A row with more than K such
    partners drops the farthest, as the reference does.  Returns (idx (B,
    n1, K) int64, mask (B, n1, K) bool); the order within a row is not
    defined.  Spanned `nlist.build` (`tracing.py`)."""
    with torch.no_grad(), tracing.span("nlist.build"):
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
                           n_knot_angular, n_knot, inv_dx, base_mask, K,
                           plain=False, spline=None):
    """The pair spline on the neighbour list (ops/pairs.py:82-121): the
    values of the dense pair spline at each row's K nearest in-cutoff
    columns.  p_table (n_t1, n_t2, m) is shared; t1 (n1,), t2 (n2,) the
    row and column types; pos and dir (B, n, 3).  Returns (values (B, n1,
    K), idx, mask) with 0 where the mask is off or the pair outside the
    cutoff.  Differentiable in the positions, directions and table.  On
    CUDA tensors the kernels `nlist_spline_fwd` and `nlist_spline_bwd`
    evaluate the list (float32 only); `spline` is the call site's
    `quadspline.PairSpline` (its types and mask those given here), which
    memoises the table's coefficients (built here when None).  On CPU
    tensors, or when `plain`, the plain version
    (`quadspline_coverage_nl_plain`)."""
    args = (p_table, t1, t2, pos1, dir1, pos2, dir2, n_knot_angular, n_knot,
            inv_dx, base_mask, K)
    if plain or pos1.device.type != "cuda":
        return quadspline_coverage_nl_plain(*args, plain=plain)
    for t in (p_table, pos1, dir1, pos2, dir2):
        if not t.is_cuda or t.dtype != torch.float32:
            raise ValueError("quadspline_coverage_nl: the kernels take "
                             "float32 CUDA tensors")
    if spline is None:
        from .quadspline import PairSpline
        spline = PairSpline(t1.cpu().numpy(), t2.cpu().numpy(),
                            base_mask.cpu().numpy(), pos1.device)
    tab = spline.table(p_table)
    if (tab.ka, tab.k, tab.inv_dx) != (n_knot_angular, n_knot, inv_dx):
        raise ValueError(f"quadspline_coverage_nl: table of family "
                         f"{(tab.ka, tab.k, 1.0 / tab.inv_dx)}, asked for "
                         f"{(n_knot_angular, n_knot, 1.0 / inv_dx)}")
    cutoff = (n_knot - 2 - 1e-6) / inv_dx
    idx, mask = neighbor_list(pos1, pos2, cutoff * cutoff, base_mask, K)
    x1 = torch.cat([pos1, dir1], -1)
    # the rotamer grid: one bead set on both sides
    x2 = x1 if pos2 is pos1 and dir2 is dir1 else torch.cat([pos2, dir2], -1)
    return _NlistSpline.apply(x1, x2, p_table, idx, mask, spline, tab), \
        idx, mask


def _nl_operands(tab, x1, x2, idx, mask):
    """The kernels' shape operands (B, n1, n2, width, n_t2, ka, k, inv_dx,
    kcut), after checking the list's shapes and dtypes."""
    B, n1, width = idx.shape
    if tuple(x1.shape) != (B, n1, 6) or x2.shape[0] != B \
            or x2.shape[2] != 6 or mask.shape != idx.shape \
            or idx.dtype != torch.int64 or mask.dtype != torch.bool:
        raise ValueError(f"nlist_spline: x1 {tuple(x1.shape)}, x2 "
                         f"{tuple(x2.shape)}, idx {tuple(idx.shape)} "
                         f"{idx.dtype}, mask {tuple(mask.shape)} "
                         f"{mask.dtype}")
    return (B, n1, x2.shape[1], width, tab.n_t2, tab.ka, tab.k, tab.inv_dx,
            tab.kcut)


def nlist_spline_fwd(ps, tab, x1, x2, idx, mask):
    """The kernel `nlist_spline_fwd`: (B, n1, width) the pair values of the
    list's slots, 0 where `mask` is off or the pair outside the cutoff.
    ps: the call site's `quadspline.PairSpline`, tab its `SplineTable`;
    x1 (B, n1, 6), x2 (B, n2, 6) float32 CUDA sites (one tensor for the
    rotamer grid); idx (B, n1, width) int64, read only where mask (bool)
    holds."""
    shape = _nl_operands(tab, x1, x2, idx, mask)
    out = x1.new_empty(idx.shape)
    kernels.launch("nlist_spline_fwd", x1, x2, idx, mask, ps.t1, ps.t2,
                   tab.coef, *shape, out)
    return out


def nlist_spline_bwd(ps, tab, x1, x2, idx, mask, g):
    """The kernel `nlist_spline_bwd` from the slots' cotangent g (B, n1,
    width), read only where the mask holds and the pair lies inside the
    cutoff: (d1 (B, n1, 6), each row's cotangent summed over its slots in a
    fixed order, dslot (B, n1, width, 6), each slot's column cotangent,
    written only where the mask holds)."""
    shape = _nl_operands(tab, x1, x2, idx, mask)
    d1 = x1.new_empty(x1.shape)
    dslot = x1.new_empty(idx.shape + (6,))
    kernels.launch("nlist_spline_bwd", x1, x2, idx, mask, ps.t1, ps.t2,
                   tab.coef, g.contiguous(), *shape, d1, dslot)
    return d1, dslot


class _NlistSpline(torch.autograd.Function):
    """values = nlist_spline_fwd(x1, x2); the backward is nlist_spline_bwd,
    its slots' column cotangents summed into the columns in a fixed order
    (`row_segments`, `gather_rows_bwd`), and, when the table requires
    grad, the table's cotangent (`fused_pair.table_cotangent` of the slots'
    cotangent on the dense grid).  x1 and x2 may be one tensor: autograd
    sums the two cotangents."""

    @staticmethod
    def forward(ctx, x1, x2, table, idx, mask, ps, tab):
        ctx.save_for_backward(x1, x2, table, idx, mask)
        ctx.ps, ctx.tab = ps, tab
        return nlist_spline_fwd(ps, tab, x1, x2, idx, mask)

    @staticmethod
    def backward(ctx, g):
        x1, x2, table, idx, mask = ctx.saved_tensors
        ps, (B, n2) = ctx.ps, x2.shape[:2]
        d1, dslot = nlist_spline_bwd(ps, ctx.tab, x1, x2, idx, mask, g)
        order, starts = row_segments(flat_rows(idx, n2), B * n2, mask)
        d2 = gather_rows_bwd(dslot.reshape(-1, 6), order, starts)
        dtab = None
        if ctx.needs_input_grad[2]:
            with tracing.span("cotangent.table"):
                dtab = table_cotangent(table, ps.t1, ps.t2, x1, x2, ps.mask,
                                       scatter_rows(g, idx, mask, n2))
        return d1, d2.reshape(B, n2, 6), dtab, None, None, None, None


def quadspline_coverage_nl_plain(p_table, t1, t2, pos1, dir1, pos2, dir2,
                                 n_knot_angular, n_knot, inv_dx, base_mask,
                                 K, plain=False):
    """`quadspline_coverage_nl` in PyTorch, as the reference computes it:
    the (B, n1, K, m) table block of the listed pairs, dense window
    weights for each segment, and autograd for the positions', directions'
    and table's cotangents; the rows' backward (`gather_rows`) takes its
    plain version when `plain`."""
    ka, k = n_knot_angular, n_knot
    cutoff = (k - 2 - 1e-6) / inv_dx
    idx, mask = neighbor_list(pos1, pos2, cutoff * cutoff, base_mask, K)
    # one gather of both, so that the backward sorts the list once
    rows2 = gather_rows(torch.cat([pos2, dir2], -1), idx, mask, plain)
    p2, d2 = rows2[..., :3], rows2[..., 3:]                   # (B, n1, K, 3)
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


def type_members(t, n_type):
    """(n_type, m) the indices of t's (n,) entries of each type, in
    increasing order, padded with n (the index of an appended zero): the
    gather table of a sum by type in a fixed order.  Built on the host
    from host types (a numpy array or a CPU tensor), so that no caller
    reads the card for it."""
    t = np.asarray(t, np.int64)
    order = np.argsort(t, kind="stable")
    counts = np.bincount(t, minlength=n_type)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(int)
    table = np.full((n_type, max(int(counts.max(initial=0)), 1)), len(t))
    table[t[order], np.arange(len(t)) - first[t[order]]] = order
    return torch.as_tensor(table)


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
