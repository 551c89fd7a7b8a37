"""The fused pair block: K1 forward, K1 backward and K3, their plain
versions, the table cotangents, and the autograd rule that joins them.

Port of `fused_pair_block_env_prep` (upside_md_tpu/ops/pallas_quadspline.py
:2403), `fused_pair_block_env` (:2135) and `fused_pair_block` (:1899).  One
pass over the bead columns evaluates up to four row bands:

  rows [0, r_b)      hbond virtuals, weighted by w = (1 - s)^2
  rows [r_b, r_e)    hydrophobe probes, weighted the same way
  rows [r_e, r_p)    environment CB probes (compact sigmoids, no spline);
                     empty when the graph fuses without its env band
  rows [r_p, n1)     the beads themselves (the rotamer pair grid)

For the spline bands the pair value is wide(r) + ang1(cos1) ang2(cos2)
narrow(r), a uniform cubic B-spline per segment (reference
bead_interaction.h:30-84), cut off at each family's own (k-2)*dx.  The
parameter table is expanded once per `advance` into per-(row type,
column type, interval) cubic coefficients (`prepare`), so an evaluation
reads four coefficients and runs Horner.  Distance segments are padded to
the larger family's knot count by edge replication, which is exact below
each family's cutoff (pallas_quadspline.py:937-946).

Outputs: the two weighted column sums (hbond and hydrophobe coverage of
each bead), the env row sums csig(r - r0) csig(dot0 - cos1) wcol[j], and
the bead-pair grid E_pair (upper triangle, different residues, zero
elsewhere) at a padded (n2p, n2p) layout.

Two backwards, as in the JAX package:

* K1 backward (`fused_pair_bwd`) reads residuals that the forward saved
  with `want_planes=True`.  The plain version's are the JAX package's
  dense planes: three derivative planes (d/d dist, d/d cos1, d/d cos2,
  pre-masked and pre-scaled) and the value plane of the coverage bands.
  The kernels' are compact (`PackedResiduals`): only the live pairs', per
  32 x 32 tile the count and, in row-major order, each live pair's code
  (row * 32 + column in the tile) and (d/d dist, d/d cos1, d/d cos2,
  coverage value).  `pack_residuals` and `unpack_residuals` are the plain
  twins that go between the two layouts;
* K3 (`fused_pair_bwd_recompute`, the recomputing `_fused_bwd_kernel`
  :1132) keeps no residuals: it recomputes each pair's spline terms from
  the coefficients.  It is the only backward of the block without its env
  band, and the memory-saving one with it (`FusedPairBlock(residuals=
  False)`, the JAX package's UPSIDE_FUSED_RESID=0).

The kernels of K1's forward and K3 walk each row tile's column tiles and
skip those farther apart in a replica than the row tile's cutoff
(`ops/tile_cull.py`; `cull_tiles` gives their decisions); K1's backward
walks only the tiles its forward found live pairs in.

The wrappers take the plain version for CPU tensors (or when asked with
`plain=True`, for comparisons on the card) and launch the CUDA kernels
(csrc/fused_pair_fwd.cu, fused_pair_bwd.cu) for CUDA tensors.  So does
the spline tables' cotangent (`table_cotangent`: the kernel of
csrc/table_cotangent.cu, which the JAX package computes in XLA outside any
kernel).  The env table's cotangent (`env_table_cotangent`) is plain
PyTorch on either device.
"""

from __future__ import annotations

import functools
from collections import namedtuple
from dataclasses import dataclass

import numpy as np
import torch

from .. import tracing
from . import kernels
from .sigmoid import compact_sigmoid
from .tile_cull import (TILE, cutoff_sq, flags_buffer, mask_words, n_tiles,
                        no_flags, pair_keep, row_tile_thresholds,
                        tile_cull)

# uniform cubic B-spline basis in powers of the in-interval fraction t:
# value = sum_kk w_kk(t) C[i-1+kk] = sum_d t^d Q_d(i), Q_d = sum_kk
# BETA[kk][d] C[i-1+kk]  (pallas_quadspline.py:92)
BETA = np.array([
    [1 / 6, -1 / 2, 1 / 2, -1 / 6],
    [4 / 6, 0.0, -1.0, 1 / 2],
    [1 / 6, 1 / 2, 1 / 2, -1 / 2],
    [0.0, 0.0, 0.0, 1 / 6],
], np.float64)


def poly_coefficients(table, ka, k):
    """Raw rows [ang1 (ka), ang2 (ka), wide (k), narrow (k)] -> per-interval
    cubic coefficients [(ka-3)*4, (ka-3)*4, (k-3)*4, (k-3)*4] (the map of
    `_poly_matrix`, pallas_quadspline.py:100), in float64."""
    table = np.asarray(table, np.float64)

    def seg(c, n):
        win = np.stack([c[..., iv:iv + 4] for iv in range(n - 3)], -2)
        return (win @ BETA).reshape(c.shape[:-1] + ((n - 3) * 4,))

    return np.concatenate([
        seg(table[..., :ka], ka), seg(table[..., ka:2 * ka], ka),
        seg(table[..., 2 * ka:2 * ka + k], k),
        seg(table[..., 2 * ka + k:], k)], axis=-1)


def pad_distance_knots(table, ka, k, k_max):
    """Pad wide/narrow from k to k_max knots by edge replication."""
    table = np.asarray(table, np.float64)
    if k == k_max:
        return table
    reps = [(0, 0)] * (table.ndim - 1) + [(0, k_max - k)]
    wide = np.pad(table[..., 2 * ka:2 * ka + k], reps, mode="edge")
    narrow = np.pad(table[..., 2 * ka + k:], reps, mode="edge")
    return np.concatenate([table[..., :2 * ka], wide, narrow], axis=-1)


@dataclass
class FusedPrep:
    """Parameter-only operands of the fused block (built by
    nodes.fusion.PairFusionPlan.prepare once per advance)."""
    r_b: int            # first hydrophobe row
    r_e: int            # first env row
    r_p: int            # first bead row
    n1: int             # rows
    n2: int             # bead columns
    n2p: int            # padded E_pair side
    ka: int
    k: int              # shared distance knot count (max of the families)
    inv_dx: float
    kcut_cov: float     # (k_cov - 2 - 1e-6): coverage cutoff in knots
    kcut_pair: float
    row_type: torch.Tensor   # (n1,) int32: spline type, or env type on E
    col_type: torch.Tensor   # (4, n2) int32: column type per band A,B,E,P
    mask: torch.Tensor       # (n1, n2) uint8 sequence/triangle mask
    coef: torch.Tensor       # (A_tot, n_ct, ncoef) float32 poly coefficients
    env_tab: torch.Tensor    # (nt1e, nt2e, 4) float32 (r0, rs, dot0, dots)
    type_rows: tuple         # row types of tab1, tab2 (offsets in row_type)

    @property
    def n_e(self):
        return self.r_p - self.r_e

    def band_of_rows(self):
        """(n1,) band index 0..3 (A, B, E, P)."""
        rows = torch.arange(self.n1, device=self.mask.device)
        return ((rows >= self.r_b).long() + (rows >= self.r_e).long()
                + (rows >= self.r_p).long())

    @property
    def cut2(self):
        """(coverage, pair) squared cutoffs in Angstrom with the cull's
        margin (`tile_cull.cutoff_sq`): K3's per-pair candidate test."""
        return (cutoff_sq(self.kcut_cov, self.inv_dx),
                cutoff_sq(self.kcut_pair, self.inv_dx))

    @functools.cached_property
    def tile_thresholds(self):
        """(n_rt,) float32 squared cull thresholds of K3's row tiles: the
        larger band cutoff of each tile's rows, +inf for a tile with env
        rows (no spline cutoff)."""
        with tracing.sync("fused_prep_bands"):
            band = self.band_of_rows().cpu().numpy()
        cov, pair = self.cut2
        rows = np.where(band == 2, np.inf, np.where(band == 3, pair, cov))
        return row_tile_thresholds(rows).to(self.mask.device)

    @functools.cached_property
    def mask_words(self):
        """(n1, n_ct) int32 packed mask (`tile_cull.mask_words`): K3's."""
        with tracing.sync("fused_prep_mask"):
            mask = self.mask.cpu().numpy()
        return mask_words(mask).to(self.mask.device)


def make_prep(tabs, type1, type2, masks, env_tab, device,
              dtype=torch.float32):
    """Build the parameter-only operands.

    tabs: (hbond coverage, hydrophobe coverage, pair) spline tables, each
    (n_type1, n_type2, 2*ka + 2*k); the families come from their shapes.
    type1 / type2 / masks: per band A, B, E, P the row types, the column
    types and the (rows, n2) interaction mask (sequence exclusion for A, B
    and E; upper triangle and different residues for P).  env_tab
    (n_type1, n_type2, 4): (r0, r_sharp, dot0, dot_sharp), or None with an
    empty E band (the block without its env band)."""
    from .pairs import quadspline_family
    tabs = [np.asarray(t, np.float64) for t in tabs]
    ka, kc, dx = quadspline_family(tabs[0].shape[-1])
    ka2, kp, dx2 = quadspline_family(tabs[2].shape[-1])
    if quadspline_family(tabs[1].shape[-1]) != (ka, kc, dx) or ka2 != ka \
            or abs(dx - dx2) > 1e-12:
        raise ValueError("fused families must share angular knots and dx")
    k = max(kc, kp)
    n_ct = max(t.shape[1] for t in tabs)
    coef = np.concatenate([
        np.pad(poly_coefficients(pad_distance_knots(t, ka, kf, k), ka, k),
               ((0, 0), (0, n_ct - t.shape[1]), (0, 0)))
        for t, kf in zip(tabs, (kc, kc, kp))], axis=0)
    A1, A2 = tabs[0].shape[0], tabs[1].shape[0]
    n_a, n_b, n_e, n2 = (len(t) for t in type1)
    if env_tab is None:         # fused without the env band
        if n_e:
            raise ValueError("env rows need an env table")
        env_tab = np.zeros((1, 1, 4))
    row_type = np.concatenate([type1[0], A1 + np.asarray(type1[1]), type1[2],
                               A1 + A2 + np.asarray(type1[3])])

    def dev(a, dt):
        return torch.as_tensor(np.array(a), dtype=dt,
                               device=device)

    return FusedPrep(
        r_b=n_a, r_e=n_a + n_b, r_p=n_a + n_b + n_e,
        n1=n_a + n_b + n_e + n2, n2=n2, n2p=-(-n2 // 128) * 128, ka=ka,
        k=k, inv_dx=1.0 / dx, kcut_cov=kc - 2 - 1e-6, kcut_pair=kp - 2 - 1e-6,
        row_type=dev(row_type, torch.int32),
        col_type=dev(np.stack(type2), torch.int32),
        mask=dev(np.concatenate(masks).astype(np.uint8), torch.uint8),
        coef=dev(coef, dtype), env_tab=dev(np.asarray(env_tab), dtype),
        type_rows=(A1, A2))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _dist2(dx, dy, dz):
    """Squared pair distances from the coordinate differences, summed in
    the kernels' order."""
    return (dx * dx + dy * dy) + dz * dz + 1e-12


def _geometry(x1, x2):
    """Pair geometry (B, n1, n2): as `_geometry` (pallas_quadspline.py:175).
    The squared distance is summed in a fixed order and the inverse is
    1 / sqrt, each step one correctly rounded operation, so the kernels
    (csrc/fused_pair.cuh `pair_geometry`) form the same distances and the
    same live pairs, bit for bit."""
    d = x2[:, None, :, 0:3] - x1[:, :, None, 0:3]
    dist2 = _dist2(*d.unbind(-1))
    inv = 1.0 / torch.sqrt(dist2)
    u = d * inv[..., None]
    cos1 = (x1[:, :, None, 3:6] * u).sum(-1)
    cos2 = -(x2[:, None, :, 3:6] * u).sum(-1)
    return u, dist2 * inv, inv, cos1, cos2


def _poly(coef, x, n, clamped):
    """Horner on the interval-selected coefficients: coef (n1, n2, (n-3)*4)
    shared over replicas, x (B, n1, n2).  Returns (value, d/dx)."""
    xc = torch.clamp(x, 1.0, float(n - 2))
    i = torch.clamp(torch.floor(xc), 1, n - 3)
    t = xc - i
    idx = ((i.long() - 1) * 4).unsqueeze(-1) + torch.arange(4, device=x.device)
    q = torch.gather(coef.expand(x.shape + coef.shape[-1:]), -1, idx)
    q0, q1, q2, q3 = q.unbind(-1)
    val = ((q3 * t + q2) * t + q1) * t + q0
    dv = (3.0 * q3 * t + 2.0 * q2) * t + q1
    if clamped:
        dv = torch.where((x <= 1.0) | (x >= n - 2.0), torch.zeros_like(dv), dv)
    return val, dv


def _live(prep, dist):
    """(B, n1, n2) live pairs: in the mask, on a spline band, and s =
    dist / dx below the band's cutoff (the kernels' exact test)."""
    band = prep.band_of_rows()
    kcut = torch.where(band == 3, prep.kcut_pair, prep.kcut_cov)
    return (prep.mask.bool() & (band != 2)[:, None]
            & (dist * prep.inv_dx < kcut[:, None]))


def live_pairs(prep, x1, x2):
    """(B, n1, n2) bool: the pairs of the spline bands that have a value
    and a cotangent (those `pack_residuals` keeps)."""
    with torch.no_grad():
        dist2 = _dist2(*(x2[:, None, :, a] - x1[:, :, None, a]
                         for a in range(3)))
        return _live(prep, dist2 * (1.0 / torch.sqrt(dist2)))


def _spline_fields(prep, x1, x2, keep=None):
    """Values, live mask and derivative planes of the spline bands; with
    `keep` (B, n_rt, n_ct) only the pairs of those tiles are live."""
    u, dist, inv, cos1, cos2 = _geometry(x1, x2)
    band = prep.band_of_rows()
    spline_row = (band != 2)[:, None]      # env rows carry env types
    zero_t = torch.zeros_like(prep.col_type[band])
    coef = prep.coef[torch.where(spline_row[:, 0], prep.row_type, 0)
                     .long()[:, None],
                     torch.where(spline_row, prep.col_type[band], zero_t)
                     .long()]                            # (n1, n2, ncoef)
    ka, k = prep.ka, prep.k
    na, nd = (ka - 3) * 4, (k - 3) * 4
    inv_dth = (ka - 3) / 2.0
    s = dist * prep.inv_dx
    a1, da1 = _poly(coef[..., :na], (cos1 + 1.0) * inv_dth + 1.0, ka, False)
    a2, da2 = _poly(coef[..., na:2 * na], (cos2 + 1.0) * inv_dth + 1.0, ka,
                    False)
    wide, dwide = _poly(coef[..., 2 * na:2 * na + nd], s, k, True)
    narrow, dnarrow = _poly(coef[..., 2 * na + nd:], s, k, True)
    live = _live(prep, dist)
    if keep is not None:
        live = live & pair_keep(keep, prep.n1, prep.n2)
    zero = torch.zeros_like(s)
    val = torch.where(live, wide + a1 * a2 * narrow, zero)
    planes = torch.stack([
        torch.where(live, (dwide + a1 * a2 * dnarrow) * prep.inv_dx, zero),
        torch.where(live, da1 * inv_dth * a2 * narrow, zero),
        torch.where(live, da2 * inv_dth * a1 * narrow, zero)], dim=1)
    return (u, dist, inv, cos1, cos2), live, val, planes


def _env_fields(prep, x1e, x2):
    """Env band (B, n_e, n2): geometry, sigmoid values and derivatives."""
    u, dist, inv, cos1, _ = _geometry(x1e, x2)
    prm = prep.env_tab[prep.row_type.long()[prep.r_e:prep.r_p, None],
                       prep.col_type.long()[2][None, :]]
    r0, rs, d0, ds = prm.unbind(-1)
    radial, dradial = compact_sigmoid(dist - r0, rs)
    angular, dangular = compact_sigmoid(d0 - cos1, ds)
    me = prep.mask[prep.r_e:prep.r_p].bool()
    return (u, inv, cos1), me, radial, dradial, angular, dangular


def fused_pair_fwd_plain(prep, x1, w1, x2, wcol, want_planes=True,
                         keep=None):
    """Plain forward.  x1 (B, n1, 6) row sites, w1 (B, n1) row weights
    (used on the two coverage bands), x2 (B, n2, 6) bead columns, wcol
    (B, n2) env column weights.  Returns (cov (B, 2, n2), E_pair (B, n2p,
    n2p), env (B, n_e), planes (B, 3, n1, n2), vcov (B, r_e, n2)); the
    last two are None unless `want_planes`.  `keep` (B, n_rt, n_ct), e.g.
    `cull_tiles`, restricts it to those tiles' pairs; the kernel's cull
    keeps every live pair and every env row tile, so restricted to its
    tiles the result is the same, bit for bit."""
    _, _, val, planes = _spline_fields(prep, x1, x2, keep)
    B = x1.shape[0]
    cov = torch.stack([
        (w1[:, :prep.r_b, None] * val[:, :prep.r_b]).sum(1),
        (w1[:, prep.r_b:prep.r_e, None] * val[:, prep.r_b:prep.r_e]).sum(1)],
        dim=1)
    grid = x1.new_zeros((B, prep.n2p, prep.n2p))
    grid[:, :prep.n2, :prep.n2] = val[:, prep.r_p:]
    _, me, radial, _, angular, _ = _env_fields(
        prep, x1[:, prep.r_e:prep.r_p], x2)
    if keep is not None:
        me = me & pair_keep(keep, prep.n1, prep.n2)[:, prep.r_e:prep.r_p]
    env = torch.where(me, wcol[:, None, :] * radial * angular,
                      torch.zeros_like(radial)).sum(-1)
    if not want_planes:
        return cov, grid, env, None, None
    return cov, grid, env, planes, val[:, :prep.r_e].contiguous()


def _bwd_plain(prep, x1, x2, wcol, fields, w1, planes, vcov, g_cov, g_grid,
               g_env, keep=None):
    """The backward of both plain versions, from the spline fields of the
    pairs (geometry, live mask) and the derivative and value planes; with
    `keep` (B, n_rt, n_ct) only the pairs of those tiles take part."""
    (u, dist, inv, cos1, cos2), live = fields[:2]
    band = prep.band_of_rows()
    B, n1, n2 = live.shape
    kept = None if keep is None else pair_keep(keep, n1, n2)
    if kept is not None:
        live = live & kept
    n2_ = prep.n2
    g_raw = torch.zeros_like(dist)
    g_raw[:, :prep.r_b] = w1[:, :prep.r_b, None] * g_cov[:, 0:1, :]
    g_raw[:, prep.r_b:prep.r_e] = w1[:, prep.r_b:prep.r_e, None] \
        * g_cov[:, 1:2, :]
    g_raw[:, prep.r_p:] = g_grid[:, :n2_, :n2_]
    zero = torch.zeros_like(dist)
    g = torch.where(live, g_raw, zero)
    radial = g * planes[:, 0]
    c1 = g * planes[:, 1]
    c2 = g * planes[:, 2]
    f1 = (c1 * inv)[..., None]
    f2 = (c2 * inv)[..., None]
    dir1 = x1[:, :, None, 3:6]
    dir2 = x2[:, None, :, 3:6]
    gvec = (radial[..., None] * u + f1 * (dir1 - cos1[..., None] * u)
            - f2 * (dir2 + cos2[..., None] * u))
    gcol = torch.zeros_like(dist)
    gcol[:, :prep.r_b] = g_cov[:, 0:1, :].expand(B, prep.r_b, n2)
    gcol[:, prep.r_b:prep.r_e] = g_cov[:, 1:2, :].expand(
        B, prep.r_e - prep.r_b, n2)
    vfull = torch.zeros_like(dist)
    vfull[:, :prep.r_e] = vcov
    dw = torch.where(live & (band < 2)[:, None], vfull * gcol, zero).sum(-1)

    d1 = x1.new_zeros((B, n1, 8))
    d1[..., 0:3] = -gvec.sum(2)
    d1[..., 3:6] = (c1[..., None] * u).sum(2)
    d1[..., 6] = dw
    d2 = x1.new_zeros((B, n2, 8))
    d2[..., 0:3] = gvec.sum(1)
    d2[..., 3:6] = -(c2[..., None] * u).sum(1)

    # env band: recomputed from geometry (no residual planes)
    x1e = x1[:, prep.r_e:prep.r_p]
    (ue, inve, cos1e), me, rad, drad, ang, dang = _env_fields(prep, x1e, x2)
    if kept is not None:
        me = me & kept[:, prep.r_e:prep.r_p]
    ze = torch.zeros_like(rad)
    ge = torch.where(me, g_env[:, :, None] * wcol[:, None, :], ze)
    rr = ge * drad * ang
    ce = -ge * rad * dang
    fe = (ce * inve)[..., None]
    gvec_e = rr[..., None] * ue + fe * (x1e[:, :, None, 3:6]
                                        - cos1e[..., None] * ue)
    d1[:, prep.r_e:prep.r_p, 0:3] = -gvec_e.sum(2)
    d1[:, prep.r_e:prep.r_p, 3:6] = (ce[..., None] * ue).sum(2)
    d2[..., 0:3] += gvec_e.sum(1)
    d2[..., 6] = torch.where(me, g_env[:, :, None] * rad * ang, ze).sum(1)
    return d1, d2


def fused_pair_bwd_plain(prep, x1, w1, x2, wcol, planes, vcov, g_cov,
                         g_grid, g_env):
    """Plain K1 backward from the saved planes.  Returns (d1 (B, n1, 8),
    d2 (B, n2, 8)): d1 columns are d/d(pos, dir) of each row site and the
    coverage weight cotangent in column 6; d2 columns are d/d(pos, dir) of
    each bead column and the env column-weight cotangent in column 6.
    Cotangents are selected (never multiplied) by mask AND inside-cutoff,
    so non-finite values in dead slots stay out."""
    return _bwd_plain(prep, x1, x2, wcol, _spline_fields(prep, x1, x2), w1,
                      planes, vcov, g_cov, g_grid, g_env)


def fused_pair_bwd_recompute_plain(prep, x1, w1, x2, wcol, g_cov, g_grid,
                                   g_env, keep=None):
    """Plain K3: the backward of `fused_pair_bwd_plain` with the planes
    recomputed from the coefficients instead of read.  `keep` (B, n_rt,
    n_ct), e.g. `cull_tiles`, restricts it to those tiles' pairs; the
    kernel's cull keeps every live pair, so restricted to its tiles the
    result is the same, bit for bit."""
    fields = _spline_fields(prep, x1, x2)
    return _bwd_plain(prep, x1, x2, wcol, fields, w1, fields[3],
                      fields[2][:, :prep.r_e], g_cov, g_grid, g_env, keep)


def cull_tiles(prep, x1, x2):
    """(B, n_rt, n_ct) bool: the tiles K1's forward and K3 walk for row
    sites x1 and bead columns x2 (`tile_cull` at the row tiles'
    thresholds)."""
    return tile_cull(x1, x2, prep.tile_thresholds)


# ---------------------------------------------------------------------------
# the compact residual of K1 and its plain twins
# ---------------------------------------------------------------------------

SLOTS = TILE * TILE      # residual slots of a tile (csrc RESID_SLOTS)

# K1 forward's residual for its backward, as the kernels keep it: counts
# (B, n_rt, n_ct) int16, the live pairs of each tile; codes (B, n_rt,
# n_ct, SLOTS) int16, slot k of a tile the code (row * 32 + column in the
# tile) of its k-th live pair in row-major order; vals (B, n_rt, n_ct,
# SLOTS, 4) float32, that pair's (d/d dist, d/d cos1, d/d cos2, value),
# the value 0 on the bead band (as the plain vcov holds it).  Slots at or
# past a tile's count are not read (the kernel leaves them unwritten).
PackedResiduals = namedtuple("PackedResiduals", "counts codes vals")


def _to_tiles(a, n_rt, n_ct):
    """(B, n1, n2, ...) -> (B, n_rt, n_ct, SLOTS, ...), zero-padded, each
    tile's pairs row-major."""
    B, n1, n2 = a.shape[:3]
    rest = a.shape[3:]
    pad = a.new_zeros((B, n_rt * TILE, n_ct * TILE) + rest)
    pad[:, :n1, :n2] = a
    t = pad.reshape((B, n_rt, TILE, n_ct, TILE) + rest).transpose(2, 3)
    return t.reshape((B, n_rt, n_ct, SLOTS) + rest)


def _from_tiles(t, n1, n2):
    """The inverse of `_to_tiles`, cut to (B, n1, n2, ...)."""
    B, n_rt, n_ct = t.shape[:3]
    rest = t.shape[4:]
    a = t.reshape((B, n_rt, n_ct, TILE, TILE) + rest).transpose(2, 3)
    return a.reshape((B, n_rt * TILE, n_ct * TILE) + rest)[:, :n1, :n2]


def residual_slots(counts):
    """(B, n_rt, n_ct, SLOTS) bool: the slots that hold a live pair."""
    return torch.arange(SLOTS, device=counts.device) < \
        counts.long()[..., None]


def pack_residuals(prep, x1, x2, planes, vcov):
    """The compact residual (`PackedResiduals`) of the plain dense planes
    (B, 3, n1, n2) and coverage values vcov (B, r_e, n2) at row sites x1
    and bead columns x2: each tile's live pairs (`live_pairs`) in
    row-major order.  Unused slots hold 0."""
    B, n1, n2 = x1.shape[0], prep.n1, prep.n2
    n_rt, n_ct = n_tiles(n1), n_tiles(n2)
    live = _to_tiles(live_pairs(prep, x1, x2), n_rt, n_ct)
    value = torch.zeros_like(planes[:, 0])
    value[:, :prep.r_e] = vcov
    fields = _to_tiles(torch.cat([planes.movedim(1, -1), value[..., None]],
                                 -1), n_rt, n_ct)
    # a live pair's slot is its rank among the tile's live pairs; the
    # others go to a spare slot past the end, dropped after the scatter
    slot = torch.where(live, torch.cumsum(live, -1) - 1, SLOTS)
    codes = torch.zeros(live.shape[:3] + (SLOTS + 1,), dtype=torch.int16,
                        device=live.device)
    codes.scatter_(-1, slot, torch.arange(SLOTS, dtype=torch.int16,
                                          device=live.device).expand_as(slot))
    vals = fields.new_zeros(live.shape[:3] + (SLOTS + 1, 4))
    vals.scatter_(-2, slot[..., None].expand(fields.shape), fields)
    return PackedResiduals(live.sum(-1).to(torch.int16),
                           codes[..., :SLOTS].contiguous(),
                           vals[..., :SLOTS, :].contiguous())


def unpack_residuals(prep, packed):
    """(planes (B, 3, n1, n2), vcov (B, r_e, n2)) of a compact residual:
    each live pair's values at its place, 0 elsewhere."""
    counts, codes, vals = packed
    valid = residual_slots(counts)
    where = torch.where(valid, codes.long(), SLOTS)
    dense = vals.new_zeros(counts.shape + (SLOTS + 1, 4))
    dense.scatter_(-2, where[..., None].expand(vals.shape),
                   torch.where(valid[..., None], vals, 0.0))
    dense = _from_tiles(dense[..., :SLOTS, :], prep.n1, prep.n2)
    return (dense[..., :3].movedim(-1, 1).contiguous(),
            dense[:, :prep.r_e, :, 3].contiguous())


# ---------------------------------------------------------------------------
# table cotangents: the spline tables' by kernel (csrc/table_cotangent.cu)
# on the card, their plain version, the env table's plain on either device
# (the JAX package computes them in XLA)
# ---------------------------------------------------------------------------

# replicas per chunk of `table_cotangent_plain`: at ubiquitin size (374 x
# 374 bead pairs, M = 34 table entries) one replica's window weights,
# gathered table rows and products take ~130 floats per pair, ~70 MB in
# float32, so a chunk of 8 holds ~0.6 GB
COTANGENT_CHUNK = 8


def table_cotangent(table, t1, t2, x1, x2, mask, g, plain=False):
    """d(sum g * value)/d(table) of a pair-spline table (n_t1, n_t2,
    2 ka + 2 k), summed over replicas: port of `_table_cotangent`
    (pallas_quadspline.py:753).  x1 (B, n1, >=6) and x2 (B, n2, >=6) are
    the row and column sites, t1 (n1,) and t2 (n2,) their types, mask
    (n1, n2) the call site's mask and g (B, n1, n2) the pair cotangent.
    The cotangent is selected, never multiplied, by mask AND inside the
    table's own cutoff.  Each pair's (M,) cotangent summed over the
    replicas, then by (type1, type2) (`sum_by_type`), each in the same
    order on every run.  The kernel (csrc/table_cotangent.cu) forms the
    pairs' sums on CUDA tensors, the plain version
    (`table_cotangent_plain`) on CPU ones or when `plain`."""
    if plain or table.device.type != "cuda":
        return table_cotangent_plain(table, t1, t2, x1, x2, mask, g)
    from .pairs import quadspline_family
    ka, k, dx = quadspline_family(table.shape[-1])
    A, Bt, M = table.shape
    B, n1, n2 = g.shape
    for t in (table, x1, x2, g):
        if not t.is_cuda or t.dtype != torch.float32:
            raise ValueError("table_cotangent: the kernel takes float32 "
                             "CUDA tensors")
    if g.stride(-1) != 1:
        g = g.contiguous()
    if mask.dtype not in (torch.bool, torch.uint8):
        mask = mask.to(torch.uint8)
    t1, t2 = t1.long().contiguous(), t2.long().contiguous()
    out = g.new_empty((M, n1, n2))
    # the sites component-major, (B, 6, n): a warp's columns read each
    # component in one coalesced load
    sites = [x[..., :6].transpose(1, 2).contiguous() for x in (x1, x2)]
    kernels.launch("table_cotangent", table.detach().contiguous(), t1, t2,
                   *sites, mask.contiguous(), g, B, n1, n2, Bt, g.stride(0),
                   g.stride(1), ka, k, 1.0 / dx, (ka - 3) / 2.0,
                   k - 2 - 1e-6, out)
    return sum_by_type(out.permute(1, 2, 0), t1, t2, A, Bt)


def table_cotangent_plain(table, t1, t2, x1, x2, mask, g):
    """`table_cotangent` in PyTorch: each pair's window weights and the
    table row it reads give its (M,) cotangent, summed over the replica
    chunks; then a (type1, type2) entry sums its pairs in the same order
    on every run (`sum_by_type`): the `index_add_` it replaces summed with
    float atomics on the card, in an order that varies run to run."""
    from .pairs import quadspline_family
    from .spline import bspline_window_weights
    ka, k, dx = quadspline_family(table.shape[-1])
    inv_dx, inv_dth = 1.0 / dx, (ka - 3) / 2.0
    A, Bt, M = table.shape
    t1, t2 = t1.long(), t2.long()
    p = table.detach()[t1[:, None], t2[None, :]]          # (n1, n2, M)
    per_pair = torch.zeros_like(p)
    for r0 in range(0, x1.shape[0], COTANGENT_CHUNK):
        sl = slice(r0, r0 + COTANGENT_CHUNK)
        _, dist, _, cos1, cos2 = _geometry(x1[sl], x2[sl])
        s = dist * inv_dx
        live = mask.bool() & (s < k - 2 - 1e-6)
        gm = torch.where(live, g[sl], torch.zeros_like(s))
        wa1 = bspline_window_weights((cos1 + 1.0) * inv_dth + 1.0, ka, False)
        wa2 = bspline_window_weights((cos2 + 1.0) * inv_dth + 1.0, ka, False)
        wd = bspline_window_weights(s, k, True)
        a1 = (wa1 * p[..., :ka]).sum(-1)
        a2 = (wa2 * p[..., ka:2 * ka]).sum(-1)
        narrow = (wd * p[..., 2 * ka + k:]).sum(-1)
        gw = torch.cat([(gm * a2 * narrow)[..., None] * wa1,
                        (gm * a1 * narrow)[..., None] * wa2,
                        gm[..., None] * wd,
                        (gm * a1 * a2)[..., None] * wd], dim=-1)
        per_pair = per_pair + gw.sum(0)
    return sum_by_type(per_pair, t1, t2, A, Bt)


def sum_by_type(per_pair, t1, t2, n_t1, n_t2):
    """(n_t1, n_t2, M): per_pair (n1, n2, M) summed over the pairs of each
    (t1, t2) type, as two products with the types' one-hot matrices (each
    row over the columns of each type, then those sums over the rows of
    each type): matrix products, which sum in the same order on every run.
    The one-hot matrices are built on the types' device, with no host
    read."""
    t1, t2 = t1.long(), t2.long()
    rows = (t1[:, None] == torch.arange(n_t1, device=t1.device)).to(
        per_pair.dtype)
    cols = (t2[:, None] == torch.arange(n_t2, device=t2.device)).to(
        per_pair.dtype)
    by_col = torch.einsum("jb,ijm->ibm", cols, per_pair)
    return torch.einsum("ia,ibm->abm", rows, by_col)


def env_rowsums(prm, me, x1e, wcol, xb):
    """Plain env band rows (B, n_e) as a function of each pair's row of
    the sigmoid table, prm (n_e, n2, 4): port of `_env_xla_rowsums`
    (pallas_quadspline.py:2172)."""
    d = xb[:, None, :, :3] - x1e[:, :, None, :3]
    dist = torch.sqrt((d * d).sum(-1) + 1e-12)
    dp = (d * x1e[:, :, None, 3:6]).sum(-1) / dist
    radial, _ = compact_sigmoid(dist - prm[..., 0], prm[..., 1])
    angular, _ = compact_sigmoid(prm[..., 2] - dp, prm[..., 3])
    val = torch.where(me.bool(), wcol[:, None, :] * radial * angular,
                      torch.zeros_like(radial))
    return val.sum(-1)


def env_table_cotangent(tab4, t1e, t2e, me, x1e, wcol, xb, g_env):
    """d(sum g_env * env)/d(tab4), as the JAX rule takes it by autodiff of
    `_env_xla_rowsums` (:2223-2227): each pair's (4,) cotangent by
    autograd through `env_rowsums`, then summed by type
    (`sum_by_type`).  Autograd through the table gather itself would
    scatter by type with PyTorch's accumulating `index_put_`, which on
    the CPU adds in an order that varies run to run."""
    t1e, t2e = t1e.long(), t2e.long()
    with torch.enable_grad():
        prm = tab4.detach()[t1e[:, None], t2e[None, :]].requires_grad_(True)
        total = (g_env * env_rowsums(prm, me, x1e.detach(), wcol.detach(),
                                     xb.detach())).sum()
        (per_pair,) = torch.autograd.grad(total, prm)
    return sum_by_type(per_pair, t1e, t2e, *tab4.shape[:2])


def block_table_cotangents(prep, needed, tabs, x1, w1, x2, wcol, g_cov,
                           g_grid, g_env, plain=False):
    """Cotangents of (tab1, tab2, tab3, tab4) where `needed` says so, else
    None.  Pair cotangents as `_fused_bwd_rule` / `_fused_env_bwd_rule`
    form them (:1943-1952, :2215-2227): w1 g_cov on the coverage bands,
    the grid cotangent cut to the beads on the pair band (a strided view,
    which the kernel reads in place).  `plain` as `table_cotangent`."""
    A1, A2 = prep.type_rows
    rt, ct, mask = prep.row_type.long(), prep.col_type, prep.mask
    n2 = prep.n2
    bands = (
        (0, prep.r_b, 0, 0,
         lambda: w1[:, :prep.r_b, None] * g_cov[:, 0:1, :]),
        (prep.r_b, prep.r_e, 1, A1,
         lambda: w1[:, prep.r_b:prep.r_e, None] * g_cov[:, 1:2, :]),
        (prep.r_p, prep.n1, 3, A1 + A2,
         lambda: g_grid[:, :n2, :n2]))
    out = [None] * 4
    for i, (lo, hi, b, off, pair_g) in enumerate(bands):
        if needed[i]:
            with tracing.span("cotangent.table"):
                out[i] = table_cotangent(tabs[i], rt[lo:hi] - off, ct[b],
                                         x1[:, lo:hi], x2, mask[lo:hi],
                                         pair_g(), plain)
    if needed[3]:
        with tracing.span("cotangent.env_table"):
            out[3] = env_table_cotangent(
                tabs[3], rt[prep.r_e:prep.r_p], ct[2],
                mask[prep.r_e:prep.r_p], x1[:, prep.r_e:prep.r_p], wcol, x2,
                g_env)
    return out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(prep, x1, w1, x2, wcol, *rest):
    """Shapes, dtype and layout of the kernel operands (rest: any further
    float32 operands, already shaped by the forward)."""
    B = x1.shape[0]
    shapes = ((B, prep.n1, 6), (B, prep.n1), (B, prep.n2, 6), (B, prep.n2))
    for t, shape in zip((x1, w1, x2, wcol), shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f"fused pair kernels: expected {shape}, got "
                             f"{tuple(t.shape)}")
    for t in (x1, w1, x2, wcol) + rest:
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("fused pair kernels take contiguous float32 "
                             "CUDA tensors")


def _shape(prep, B):
    return (B, prep.n1, prep.n2, prep.n2p, prep.r_b, prep.r_e, prep.r_p,
            prep.ka, prep.k, prep.coef.shape[1], prep.coef.shape[2],
            prep.env_tab.shape[1], prep.inv_dx, prep.kcut_cov,
            prep.kcut_pair)


def _check_cotangents(prep, B, g_cov, g_grid, g_env):
    if tuple(g_cov.shape) != (B, 2, prep.n2) or \
            tuple(g_grid.shape) != (B, prep.n2p, prep.n2p) or \
            tuple(g_env.shape) != (B, prep.n_e):
        raise ValueError("fused pair backward: cotangent shapes")


def _residual_layout(prep, B):
    """((shape, dtype) of counts, codes, vals) of B replicas' residual."""
    tiles = (B, n_tiles(prep.n1), n_tiles(prep.n2))
    return ((tiles, torch.int16), (tiles + (SLOTS,), torch.int16),
            (tiles + (SLOTS, 4), torch.float32))


def residual_buffers(prep, B, device):
    """Empty `PackedResiduals` for B replicas: what K1's forward writes."""
    return PackedResiduals(*(torch.empty(shape, dtype=dt, device=device)
                             for shape, dt in _residual_layout(prep, B)))


def fused_pair_fwd(prep, x1, w1, x2, wcol, plain=False, want_planes=True,
                   flags=None):
    """K1 forward: the plain version on CPU tensors (or when asked), the
    CUDA kernel on CUDA tensors.  Returns (cov, E_pair, env, residual):
    with `want_planes` the residual its backward reads, the plain dense
    (planes, vcov) or the kernel's `PackedResiduals`; without it None (the
    `_fused_fwd_kernel` variant without planes, :1021).  The kernel makes
    its own cull and, given `flags` (B, n_rt, n_ct) uint8, writes its
    decisions there (`tile_cull.KEPT`; `WRITTEN` where a coverage pair was
    live); the plain version has none and refuses `flags`."""
    if plain or not x1.is_cuda:
        no_flags(flags)
        cov, grid, env, planes, vcov = fused_pair_fwd_plain(
            prep, x1, w1, x2, wcol, want_planes)
        return cov, grid, env, (planes, vcov) if want_planes else None
    x1, w1, x2, wcol = (t.contiguous() for t in (x1, w1, x2, wcol))
    _check(prep, x1, w1, x2, wcol)
    B = x1.shape[0]
    n_rt, n_ct = n_tiles(prep.n1), n_tiles(prep.n2)
    flags = flags_buffer(flags, (B, n_rt, n_ct), x1.device)
    f32 = dict(dtype=torch.float32, device=x1.device)
    cov = torch.empty((B, 2, prep.n2), **f32)
    grid = torch.empty((B, prep.n2p, prep.n2p), **f32)   # zeroed by the call
    env = torch.empty((B, prep.n_e), **f32)
    colpart = torch.empty((B, n_rt, prep.n2, 2), **f32)
    res = residual_buffers(prep, B, x1.device) if want_planes else None
    kernels.launch("fused_pair_fwd", x1, w1, x2, wcol, prep.row_type,
                   prep.col_type, prep.mask_words, prep.coef, prep.env_tab,
                   prep.tile_thresholds, *_shape(prep, B), *prep.cut2, flags,
                   *(res if want_planes else (None, None, None)), colpart,
                   grid, cov, env)
    return cov, grid, env, res


def fused_pair_bwd(prep, x1, w1, x2, wcol, residual, g_cov, g_grid, g_env,
                   plain=False):
    """K1 backward from the forward's residual: plain on CPU tensors (or
    when asked; a `PackedResiduals` is unpacked first), the CUDA kernel on
    CUDA tensors, which reads only the packed layout.  Returns (d1 (B, n1,
    8), d2 (B, n2, 8)) as `fused_pair_bwd_plain`."""
    if plain or not x1.is_cuda:
        if isinstance(residual, PackedResiduals):
            residual = unpack_residuals(prep, residual)
        return fused_pair_bwd_plain(prep, x1, w1, x2, wcol, *residual, g_cov,
                                    g_grid, g_env)
    if not isinstance(residual, PackedResiduals):
        raise ValueError("the K1 backward kernel reads the packed residual "
                         "of the K1 forward kernel")
    args = [t.contiguous() for t in (x1, w1, x2, wcol, g_cov, g_grid, g_env)]
    _check(prep, *args)
    x1, w1, x2, wcol, g_cov, g_grid, g_env = args
    B = x1.shape[0]
    _check_cotangents(prep, B, g_cov, g_grid, g_env)
    n_rt, n_ct = n_tiles(prep.n1), n_tiles(prep.n2)
    for t, (shape, dt) in zip(residual, _residual_layout(prep, B)):
        if tuple(t.shape) != shape or t.dtype != dt or not t.is_cuda or \
                not t.is_contiguous():
            raise ValueError(f"K1 backward: residual {tuple(t.shape)} "
                             f"{t.dtype}, expected {shape} {dt}")
    # the tiles whose column partials the kernel wrote
    flags = torch.empty((B, n_rt, n_ct), dtype=torch.uint8,
                        device=x1.device)
    f32 = dict(dtype=torch.float32, device=x1.device)
    d2part = torch.empty((B, n_rt, prep.n2, 8), **f32)
    d1 = torch.empty((B, prep.n1, 8), **f32)
    d2 = torch.empty((B, prep.n2, 8), **f32)
    kernels.launch(
        "fused_pair_bwd", x1, w1, x2, wcol, prep.row_type, prep.col_type,
        prep.mask_words, prep.env_tab, *residual, g_cov, g_grid, g_env, B,
        prep.n1, prep.n2, prep.n2p, prep.r_b, prep.r_e, prep.r_p,
        prep.env_tab.shape[1], d2part, flags, d1, d2)
    return d1, d2


def fused_pair_bwd_recompute(prep, x1, w1, x2, wcol, g_cov, g_grid, g_env,
                             plain=False, flags=None):
    """K3, the recomputing backward: plain on CPU tensors (or when asked),
    CUDA kernel on CUDA tensors.  Same outputs as `fused_pair_bwd`.  The
    kernel makes its own cull and, given `flags` (B, n_rt, n_ct) uint8,
    writes its decisions there (`tile_cull.KEPT`, `WRITTEN`); the plain
    version has none and refuses `flags`."""
    if plain or not x1.is_cuda:
        no_flags(flags)
        return fused_pair_bwd_recompute_plain(prep, x1, w1, x2, wcol, g_cov,
                                              g_grid, g_env)
    args = [t.contiguous() for t in (x1, w1, x2, wcol, g_cov, g_grid,
                                     g_env)]
    _check(prep, *args)
    x1, w1, x2, wcol, g_cov, g_grid, g_env = args
    B = x1.shape[0]
    _check_cotangents(prep, B, g_cov, g_grid, g_env)
    n_rt, n_ct = n_tiles(prep.n1), n_tiles(prep.n2)
    flags = flags_buffer(flags, (B, n_rt, n_ct), x1.device)
    f32 = dict(dtype=torch.float32, device=x1.device)
    d2part = torch.empty((B, n_rt, prep.n2, 8), **f32)
    d1 = torch.empty((B, prep.n1, 8), **f32)
    d2 = torch.empty((B, prep.n2, 8), **f32)
    kernels.launch("fused_pair_bwd_recompute", x1, w1, x2, wcol,
                   prep.row_type, prep.col_type, prep.mask_words, prep.coef,
                   prep.env_tab, g_cov, g_grid, g_env, prep.tile_thresholds,
                   *_shape(prep, B), *prep.cut2, d2part, flags, d1, d2)
    return d1, d2


class FusedPairBlock(torch.autograd.Function):
    """cov, E_pair, env = block(x1, w1, x2, wcol; tab1, tab2, tab3, tab4).

    With `residuals` and the env band (the MD path) the forward saves its
    residual and K1's backward reads it (the custom_vjp of
    pallas_quadspline.py:2402-2453): the dense planes on the plain path,
    the kernels' compact `PackedResiduals` on the card.  Otherwise the
    forward saves none and K3 recomputes the planes: always without the
    env band (`fused_pair_block`, :1899-1957), and with it when
    `residuals` is False (`fused_pair_block_env` under
    UPSIDE_FUSED_RESID=0, :2161-2230).  The tables are inputs so that
    their cotangents reach them; each is computed only when autograd asks
    for it (training)."""

    @staticmethod
    def forward(ctx, x1, w1, x2, wcol, tab1, tab2, tab3, tab4, prep, plain,
                residuals):
        want = residuals and prep.n_e > 0
        cov, grid, env, res = fused_pair_fwd(prep, x1, w1, x2, wcol, plain,
                                             want)
        ctx.packed = isinstance(res, PackedResiduals)
        ctx.n_res = 0 if res is None else len(res)
        ctx.save_for_backward(x1, w1, x2, wcol, tab1, tab2, tab3, tab4,
                              *(res or ()))
        ctx.prep, ctx.plain = prep, plain
        return cov, grid, env

    @staticmethod
    def backward(ctx, g_cov, g_grid, g_env):
        x1, w1, x2, wcol, *rest = ctx.saved_tensors
        tabs, res = rest[:4], rest[4:]
        prep = ctx.prep
        if ctx.n_res:
            res = PackedResiduals(*res) if ctx.packed else tuple(res)
            d1, d2 = fused_pair_bwd(prep, x1, w1, x2, wcol, res, g_cov,
                                    g_grid, g_env, ctx.plain)
        else:
            d1, d2 = fused_pair_bwd_recompute(prep, x1, w1, x2, wcol, g_cov,
                                              g_grid, g_env, ctx.plain)
        dtabs = block_table_cotangents(prep, ctx.needs_input_grad[4:8], tabs,
                                       x1, w1, x2, wcol, g_cov, g_grid,
                                       g_env, ctx.plain)
        return (d1[..., :6], d1[..., 6], d2[..., :6], d2[..., 6], *dtabs,
                None, None, None)


def fused_pair_block(prep, x1, w1, x2, wcol, plain=False, tabs=None,
                     residuals=True):
    """(cov, E_pair, env); `tabs` = (tab1, tab2, tab3, tab4 or None), the
    tensors `prep` was built from, for their cotangents.  A call that no
    backward can follow (grad mode off, or no input requiring grad: the
    energy-only evaluations of MC moves and replica swaps) keeps no
    residual."""
    tabs = tuple(tabs) if tabs is not None else (None,) * 4
    residuals = residuals and torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x1, w1, x2, wcol) + tabs)
    return FusedPairBlock.apply(x1, w1, x2, wcol, *tabs, prep, plain,
                                residuals)
