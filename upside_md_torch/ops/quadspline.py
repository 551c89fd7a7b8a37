"""The unfused pair spline: K5 (dense pair grid) and K4 (weighted column
sums), their plain versions, and the autograd rules that join them.

Port of `quadspline_pallas` (upside_md_tpu/ops/pallas_quadspline.py:737)
and `quadspline_colsum_pallas` (:883).  For site rows x1 (B, n1, 6) and
bead columns x2 (B, n2, 6), both (position, unit direction), the pair
value is wide(r) + ang1(cos1) ang2(cos2) narrow(r), a uniform cubic
B-spline per segment (reference bead_interaction.h:30-84), where the
static (n1, n2) mask holds and the scaled distance is inside the cutoff
s < k - 2 - 1e-6 (:273).  K5 returns the (B, n1, n2) grid; K4 returns
out[j] = sum_i w1[i] value(i, j), so the grid never exists.

The parameter table is expanded into per-(row type, column type,
interval) cubic coefficients (`fused_pair.poly_coefficients`), memoised on
the table tensor; an evaluation reads four coefficients per segment and
runs Horner.  The backward recomputes the pair terms (no residual planes)
and follows the reference derivative partition (:311-322): cotangents
d1 (B, n1, 8) and d2 (B, n2, 8) hold d/d(pos, dir) in columns 0-5, and
for K4 column 6 of d1 holds d/dw1.  Cotangents are selected, never
multiplied, by mask AND inside-cutoff.

The table cotangent (`_table_cotangent`, :753, XLA in the JAX package) is
plain PyTorch (`fused_pair.table_cotangent`), computed only when the table
requires grad (training): the pair cotangent is g for K5 (:790-798) and
w1[i] g[j] for K4 (:900-916).

The wrappers take the plain version for CPU tensors (or when asked with
`plain=True`, for comparisons on the card) and launch the CUDA kernels
(csrc/quadspline.cu) for CUDA tensors.  All four kernels walk each row
tile's column tiles and skip those whose static mask is empty or that lie
farther apart in a replica than the cutoff (`ops/tile_cull.py`;
`cull_tiles` gives their decisions); K5's forward zeroes each 32-row band
of its grid before it stores the band's live values, so the one kernel
writes every element of the grid.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import kernels
from .fused_pair import _geometry, poly_coefficients, table_cotangent
from .pairs import quadspline_family
from .tile_cull import (cutoff_sq, flags_buffer, mask_words, no_flags,
                        pair_keep, tile_cull)


@dataclass
class SplineTable:
    """Parameter-only operands of one table: poly coefficients (n_t1, n_t2,
    ncoef) in the table's dtype and the family's constants."""
    coef: torch.Tensor
    ka: int
    k: int
    inv_dx: float
    kcut: float          # cutoff in units of dx: k - 2 - 1e-6

    @property
    def n_t2(self):
        return self.coef.shape[1]

    @property
    def ncoef(self):
        return self.coef.shape[2]


class PairSpline:
    """Static operands of one call site (row types, column types, the
    (n1, n2) interaction mask, packed as the row-tile kernels read it, and
    its per-tile liveness), and the memo of
    its table's coefficients, rebuilt only when the table tensor changes
    (as System.fused_prepared is)."""

    def __init__(self, t1, t2, mask, device):
        mask = np.asarray(mask, bool)
        self.n1, self.n2 = mask.shape
        tr, tc = kernels.TILE_ROWS, kernels.TILE_COLS
        n_rt, n_ct = -(-self.n1 // tr), -(-self.n2 // tc)
        padded = np.zeros((n_rt * tr, n_ct * tc), bool)
        padded[:self.n1, :self.n2] = mask
        alive = padded.reshape(n_rt, tr, n_ct, tc).any(axis=(1, 3))
        self.t1 = torch.as_tensor(np.asarray(t1, np.int32), device=device)
        self.t2 = torch.as_tensor(np.asarray(t2, np.int32), device=device)
        self.mask = torch.as_tensor(mask.astype(np.uint8), device=device)
        self.tile_alive = torch.as_tensor(alive.astype(np.uint8),
                                          device=device)
        self.mask_words = mask_words(mask).to(device)
        self._memo = None

    def table(self, table):
        key = (id(table), table._version)
        if self._memo is None or self._memo[0] != key:
            ka, k, dx = quadspline_family(table.shape[-1])
            coef = poly_coefficients(table.detach().cpu().numpy(), ka, k)
            self._memo = (key, table, SplineTable(
                torch.as_tensor(coef, dtype=table.dtype,
                                device=table.device),
                ka, k, 1.0 / dx, k - 2 - 1e-6))
        return self._memo[2]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def in_cutoff(ps, tab, dist):
    """The pairs a call site evaluates: its static mask and the scaled
    distance inside the cutoff, s < k - 2 - 1e-6 (:273)."""
    return ps.mask.bool() & (dist * tab.inv_dx < tab.kcut)


def live_pairs(ps, tab, x1, x2):
    """(B, n1, n2) bool `in_cutoff` from positions alone, without the rest
    of the pair geometry (the rotamer adjacency needs no more)."""
    with torch.no_grad():
        dist2 = sum((x2[:, None, :, a] - x1[:, :, None, a]) ** 2
                    for a in range(3)) + 1e-12
        return in_cutoff(ps, tab, dist2 * torch.rsqrt(dist2))


def _poly_at(flat, base, x, n, clamped):
    """Horner on the 4 coefficients of x's interval: flat coefficient
    table, base (n1, n2) offset of each pair's segment, x (B, n1, n2).
    Returns (value, d/dx)."""
    xc = torch.clamp(x, 1.0, float(n - 2))
    i = torch.clamp(torch.floor(xc), 1, n - 3)
    t = xc - i
    idx = base + (i.long() - 1) * 4
    q0, q1, q2, q3 = (flat[idx + d] for d in range(4))
    val = ((q3 * t + q2) * t + q1) * t + q0
    dv = (3.0 * q3 * t + 2.0 * q2) * t + q1
    if clamped:
        dv = torch.where((x <= 1.0) | (x >= n - 2.0), torch.zeros_like(dv), dv)
    return val, dv


def _terms(ps, tab, x1, x2):
    """Geometry, live mask, and the four segments' values and derivatives
    of every pair (B, n1, n2)."""
    geom = _geometry(x1, x2)
    ka, k = tab.ka, tab.k
    na, nd = (ka - 3) * 4, (k - 3) * 4
    inv_dth = (ka - 3) / 2.0
    base = (ps.t1.long()[:, None] * tab.n_t2
            + ps.t2.long()[None, :]) * tab.ncoef
    flat = tab.coef.reshape(-1)
    s = geom[1] * tab.inv_dx
    a1 = _poly_at(flat, base, (geom[3] + 1.0) * inv_dth + 1.0, ka, False)
    a2 = _poly_at(flat, base + na, (geom[4] + 1.0) * inv_dth + 1.0, ka,
                  False)
    wide = _poly_at(flat, base + 2 * na, s, k, True)
    nar = _poly_at(flat, base + 2 * na + nd, s, k, True)
    return geom, in_cutoff(ps, tab, geom[1]), a1, a2, wide, nar


def _value(live, a1, a2, wide, nar):
    v = wide[0] + a1[0] * a2[0] * nar[0]
    return torch.where(live, v, torch.zeros_like(v))


def _restrict(ps, live, keep):
    """`live` restricted to the tiles of `keep` (B, n_rt, n_ct; None:
    all)."""
    return live if keep is None else live & pair_keep(keep, ps.n1, ps.n2)


def quadspline_fwd_plain(ps, tab, x1, x2, keep=None):
    """Plain K5 forward: the (B, n1, n2) masked pair values, 0 where no
    pair is live.  `keep` (B, n_rt, n_ct), e.g. `cull_tiles`, restricts
    it to those tiles' pairs; the kernel's cull keeps every live pair, so
    restricted to its tiles the grid is the same, bit for bit."""
    _, live, a1, a2, wide, nar = _terms(ps, tab, x1, x2)
    return _value(_restrict(ps, live, keep), a1, a2, wide, nar)


def colsum_fwd_plain(ps, tab, x1, x2, w1, keep=None):
    """Plain K4 forward: (B, n2) column sums of w1[i] value(i, j), each
    term selected by the live test (a row weight no live pair reads does
    not reach the sums).  `keep` (B, n_rt, n_ct), e.g. `cull_tiles`,
    restricts it to those tiles' pairs; the kernel's cull keeps every live
    pair, so restricted to its tiles the result is the same, bit for
    bit."""
    _, live, a1, a2, wide, nar = _terms(ps, tab, x1, x2)
    live = _restrict(ps, live, keep)
    v = w1[:, :, None] * (wide[0] + a1[0] * a2[0] * nar[0])
    return torch.where(live, v, torch.zeros_like(v)).sum(1)


def _backward(ps, tab, x1, x2, g_pair, g_col=None, keep=None):
    """d1 (B, n1, 8), d2 (B, n2, 8) from the pair cotangent g_pair
    (B, n1, n2); with g_col (B, n2) (K4) also d/dw1 = sum_j g_col value.
    With `keep` (B, n_rt, n_ct) only the pairs of those tiles take part."""
    (u, dist, inv, cos1, cos2), live, a1, a2, wide, nar = _terms(
        ps, tab, x1, x2)
    live = _restrict(ps, live, keep)
    inv_dth = (tab.ka - 3) / 2.0
    zero = torch.zeros_like(dist)
    g = torch.where(live, g_pair, zero)
    radial = g * (wide[1] + a1[0] * a2[0] * nar[1]) * tab.inv_dx
    c1 = g * a1[1] * inv_dth * a2[0] * nar[0]
    c2 = g * a2[1] * inv_dth * a1[0] * nar[0]
    f1 = (c1 * inv)[..., None]
    f2 = (c2 * inv)[..., None]
    gvec = (radial[..., None] * u
            + f1 * (x1[:, :, None, 3:6] - cos1[..., None] * u)
            - f2 * (x2[:, None, :, 3:6] + cos2[..., None] * u))
    B, n1, n2 = dist.shape
    d1 = x1.new_zeros((B, n1, 8))
    d1[..., 0:3] = -gvec.sum(2)
    d1[..., 3:6] = (c1[..., None] * u).sum(2)
    if g_col is not None:
        gc = g_col[:, None, :].expand(B, n1, n2)
        d1[..., 6] = torch.where(live, gc * _value(live, a1, a2, wide, nar),
                                 zero).sum(-1)
    d2 = x1.new_zeros((B, n2, 8))
    d2[..., 0:3] = gvec.sum(1)
    d2[..., 3:6] = -(c2[..., None] * u).sum(1)
    return d1, d2


def quadspline_bwd_plain(ps, tab, x1, x2, g, keep=None):
    """Plain K5 backward from the (B, n1, n2) cotangent.  `keep` (B, n_rt,
    n_ct), e.g. `cull_tiles`, restricts it to those tiles' pairs; the
    kernel's cull keeps every live pair, so restricted to its tiles the
    result is the same, bit for bit."""
    return _backward(ps, tab, x1, x2, g, keep=keep)


def colsum_bwd_plain(ps, tab, x1, x2, w1, g, keep=None):
    """Plain K4 backward from the (B, n2) cotangent: the pair cotangent is
    w1[i] g[j].  `keep` (B, n_rt, n_ct), e.g. `cull_tiles`, restricts it to
    those tiles' pairs; the kernel's cull keeps every live pair, so
    restricted to its tiles the result is the same, bit for bit."""
    return _backward(ps, tab, x1, x2, w1[:, :, None] * g[:, None, :], g,
                     keep)


def cull_tiles(ps, tab, x1, x2):
    """(B, n_rt, n_ct) bool: the tiles K4's and K5's forward and backward
    walk for row sites x1 and columns x2: static mask alive and
    the boxes within the cutoff (`tile_cull` at `cutoff_sq` of the table's
    family)."""
    n_rt = ps.tile_alive.shape[0]
    thr = torch.full((n_rt,), cutoff_sq(tab.kcut, tab.inv_dx),
                     dtype=torch.float32)
    return tile_cull(x1, x2, thr, ps.tile_alive)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _operands(ps, tab, *tensors):
    """Check the kernel operands: contiguous float32 CUDA tensors of the
    call site's shapes (x1 (B, n1, 6), x2 (B, n2, 6), then any of w1
    (B, n1), g (B, n1, n2) or (B, n2), as given)."""
    x1 = tensors[0]
    B = x1.shape[0]
    for t in tensors:
        if not t.is_cuda or t.dtype != torch.float32:
            raise ValueError("pair spline kernels take float32 CUDA tensors")
    if tuple(x1.shape) != (B, ps.n1, 6) or \
            tuple(tensors[1].shape) != (B, ps.n2, 6):
        raise ValueError(f"pair spline kernels: expected x1 {(B, ps.n1, 6)}"
                         f" and x2 {(B, ps.n2, 6)}, got {tuple(x1.shape)}, "
                         f"{tuple(tensors[1].shape)}")
    if tab.coef.dtype != torch.float32 or not tab.coef.is_cuda:
        raise ValueError("pair spline kernels take a float32 CUDA table")
    return B, [t.contiguous() for t in tensors]


def _family(ps, tab, B):
    return (B, ps.n1, ps.n2, tab.ka, tab.k, tab.n_t2, tab.ncoef, tab.inv_dx,
            tab.kcut)


def _walk(name, ps, tab, x1, x2, operands, flags, part_width, outs):
    """Launches row-tile kernel `name` (K4's forward and backward, K5's
    backward) on `operands` (between the sites and the statics) with its
    column-partial buffer (B, n_rt, n2, part_width) and `flags` (the
    caller's, checked, or a new one), writing `outs`."""
    B = x1.shape[0]
    n_rt, n_ct = ps.tile_alive.shape
    flags = flags_buffer(flags, (B, n_rt, n_ct), x1.device)
    part = torch.empty((B, n_rt, ps.n2, part_width), dtype=torch.float32,
                       device=x1.device)
    kernels.launch(name, x1, x2, *operands, ps.t1, ps.t2, ps.mask_words,
                   ps.tile_alive, tab.coef, *_family(ps, tab, B),
                   cutoff_sq(tab.kcut, tab.inv_dx), part, flags, *outs)


def quadspline_fwd(ps, tab, x1, x2, plain=False, flags=None):
    """K5 forward: (B, n1, n2) pair values.  x1 and x2 may be one tensor
    (the rotamer grid).  The kernel writes every element of the grid and
    makes its own cull; given `flags` (B, n_rt, n_ct) uint8, it writes its
    decisions there (`tile_cull.KEPT`, and `WRITTEN` where the tile held a
    live pair); the plain version has none and refuses `flags`."""
    if plain or not x1.is_cuda:
        no_flags(flags)
        return quadspline_fwd_plain(ps, tab, x1, x2)
    B, (x1, x2) = _operands(ps, tab, x1, x2)
    flags = flags_buffer(flags, (B,) + tuple(ps.tile_alive.shape),
                         x1.device)
    out = torch.empty((B, ps.n1, ps.n2), dtype=torch.float32,
                      device=x1.device)
    kernels.launch("quadspline_fwd", x1, x2, ps.t1, ps.t2, ps.mask_words,
                   ps.tile_alive, tab.coef, *_family(ps, tab, B),
                   cutoff_sq(tab.kcut, tab.inv_dx), flags, out)
    return out


def quadspline_bwd(ps, tab, x1, x2, g, plain=False, flags=None):
    """K5 backward: (d1 (B, n1, 8), d2 (B, n2, 8)).  x1 and x2 may be
    one tensor (the rotamer grid).  The kernel makes its own cull and,
    given `flags` (B, n_rt, n_ct) uint8, writes its decisions there
    (`tile_cull.KEPT`, `WRITTEN`); the plain version has none and refuses
    `flags`."""
    if plain or not x1.is_cuda:
        no_flags(flags)
        return quadspline_bwd_plain(ps, tab, x1, x2, g)
    B, (x1, x2, g) = _operands(ps, tab, x1, x2, g)
    if tuple(g.shape) != (B, ps.n1, ps.n2):
        raise ValueError(f"quadspline_bwd: cotangent shape {tuple(g.shape)}")
    f32 = dict(dtype=torch.float32, device=x1.device)
    d1 = torch.empty((B, ps.n1, 8), **f32)
    d2 = torch.empty((B, ps.n2, 8), **f32)
    _walk("quadspline_bwd", ps, tab, x1, x2, (g,), flags, 8, (d1, d2))
    return d1, d2


def colsum_fwd(ps, tab, x1, x2, w1, plain=False, flags=None):
    """K4 forward: (B, n2) weighted column sums.  `flags` as for
    `colsum_bwd`."""
    if plain or not x1.is_cuda:
        no_flags(flags)
        return colsum_fwd_plain(ps, tab, x1, x2, w1)
    B, (x1, x2, w1) = _operands(ps, tab, x1, x2, w1)
    if tuple(w1.shape) != (B, ps.n1):
        raise ValueError(f"colsum_fwd: weight shape {tuple(w1.shape)}")
    out = torch.empty((B, ps.n2), dtype=torch.float32, device=x1.device)
    _walk("colsum_fwd", ps, tab, x1, x2, (w1,), flags, 1, (out,))
    return out


def colsum_bwd(ps, tab, x1, x2, w1, g, plain=False, flags=None):
    """K4 backward: (d1 (B, n1, 8) with d/dw1 in column 6, d2 (B, n2, 8)).
    The kernel makes its own cull and, given `flags` (B, n_rt, n_ct)
    uint8, writes its decisions there (`tile_cull.KEPT`, `WRITTEN`); the
    plain version has none and refuses `flags`."""
    if plain or not x1.is_cuda:
        no_flags(flags)
        return colsum_bwd_plain(ps, tab, x1, x2, w1, g)
    B, (x1, x2, w1, g) = _operands(ps, tab, x1, x2, w1, g)
    if tuple(w1.shape) != (B, ps.n1) or tuple(g.shape) != (B, ps.n2):
        raise ValueError("colsum_bwd: weight or cotangent shape")
    f32 = dict(dtype=torch.float32, device=x1.device)
    d1 = torch.empty((B, ps.n1, 8), **f32)
    d2 = torch.empty((B, ps.n2, 8), **f32)
    _walk("colsum_bwd", ps, tab, x1, x2, (w1, g), flags, 8, (d1, d2))
    return d1, d2


# ---------------------------------------------------------------------------
# autograd rules
# ---------------------------------------------------------------------------

def _table_grad(ctx, index, table, x1, x2, g_pair):
    """The table's cotangent if autograd asks for it, else None."""
    if not ctx.needs_input_grad[index]:
        return None
    ps = ctx.ps
    return table_cotangent(table, ps.t1, ps.t2, x1, x2, ps.mask, g_pair())


class QuadSpline(torch.autograd.Function):
    """value = K5(x1, x2); the backward is the K5 backward kernel.  x1 and
    x2 may be the same tensor: autograd sums the two cotangents."""

    @staticmethod
    def forward(ctx, x1, x2, table, ps, plain):
        tab = ps.table(table)
        ctx.save_for_backward(x1, x2, table)
        ctx.ps, ctx.tab, ctx.plain = ps, tab, plain
        return quadspline_fwd(ps, tab, x1, x2, plain)

    @staticmethod
    def backward(ctx, g):
        x1, x2, table = ctx.saved_tensors
        d1, d2 = quadspline_bwd(ctx.ps, ctx.tab, x1, x2, g, ctx.plain)
        return (d1[..., :6], d2[..., :6],
                _table_grad(ctx, 2, table, x1, x2, lambda: g), None, None)


class QuadSplineColsum(torch.autograd.Function):
    """out = K4(x1, x2, w1); the backward is the K4 backward kernel, with
    gradients to x1, x2 and the row weights w1."""

    @staticmethod
    def forward(ctx, x1, x2, w1, table, ps, plain):
        tab = ps.table(table)
        ctx.save_for_backward(x1, x2, w1, table)
        ctx.ps, ctx.tab, ctx.plain = ps, tab, plain
        return colsum_fwd(ps, tab, x1, x2, w1, plain)

    @staticmethod
    def backward(ctx, g):
        x1, x2, w1, table = ctx.saved_tensors
        d1, d2 = colsum_bwd(ctx.ps, ctx.tab, x1, x2, w1, g, ctx.plain)
        dtab = _table_grad(ctx, 3, table, x1, x2,
                           lambda: w1[:, :, None] * g[:, None, :])
        return d1[..., :6], d2[..., :6], d1[..., 6], dtab, None, None


def quadspline(ps, table, x1, x2, plain=False):
    """(B, n1, n2) pair values; differentiable in x1, x2 and the table."""
    return QuadSpline.apply(x1, x2, table, ps, plain)


def quadspline_colsum(ps, table, x1, x2, w1, plain=False):
    """(B, n2) sum_i w1[i] value(i, j); differentiable in x1, x2, w1 and
    the table."""
    return QuadSplineColsum.apply(x1, x2, w1, table, ps, plain)
