"""The per-replica tile cull of the row-tile kernels (K1's forward,
`fused_pair_fwd`, K3, `fused_pair_bwd_recompute`, and K4's and K5's
forward and backward, `colsum_fwd`, `colsum_bwd`, `quadspline_fwd`,
`quadspline_bwd`), and its plain version.

A kernel block owns one 32-row tile of one replica and walks the 32-column
tiles in order.  Before it touches a pair of a column tile it tests the
axis-aligned box of its row tile's sites in this replica against the box of
the column tile's sites: when the squared gap between the boxes exceeds the
tile's threshold, no pair of the two tiles is inside a cutoff and the tile
is skipped (csrc/pair_cull.cuh).  The threshold of a row tile is the
largest `cutoff_sq` of the bands its rows hold, where `cutoff_sq` is the
squared cutoff in Angstrom widened by `CULL_MARGIN`, so that float32
rounding of the pair distances never drops a live pair; a row tile that
holds rows without a spline cutoff (the env band) is never culled
(threshold +inf).  Padded rows and columns (n not a multiple of 32) are
not in any box.

Box corners are minima and maxima, exact in float32; the gap is formed
with the same float32 operations in the same order here and in the kernel
(per axis max(lo1 - hi2, lo2 - hi1, 0), then (gx^2 + gy^2) + gz^2, each
rounded), and the thresholds are the same float32 numbers, so `tile_cull`
gives the kernel's decisions bit for bit.  The kernels write their
decisions as `flags` (B, n_rt, n_ct) uint8: KEPT where the tile was walked,
and WRITTEN where a pair of it also added to the column sums (K1's forward:
a live pair of a coverage band; K3: a live pair or a masked-in env pair;
K4's backward: a live pair), so that its column partial sums were written
and the summing pass reads them; K5's forward, which has no column sums,
marks WRITTEN the walked tiles that held a live pair, whose values it
stored.  K1's backward takes no cull: it walks the tiles its forward found
live pairs in, and marks them the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import TILE_ROWS

TILE = TILE_ROWS     # rows, and columns (TILE_COLS), of a tile
CULL_MARGIN = 1e-3   # Angstrom added to every cutoff before the test
KEPT, WRITTEN = 1, 2


def cutoff_sq(kcut, inv_dx):
    """(kcut / inv_dx + CULL_MARGIN)^2: the squared distance, in Angstrom,
    beyond which a pair of a spline family with cutoff `kcut` (in knots)
    cannot be live.  A Python float; the kernels take it as float32."""
    return (kcut / inv_dx + CULL_MARGIN) ** 2


def n_tiles(n):
    return -(-n // TILE)


def row_tile_thresholds(cut2_rows):
    """(n_rt,) float32 thresholds of the row tiles from (n1,) per-row
    squared cutoffs (float64 numpy; +inf for a row without a cutoff): the
    largest of each tile's rows, as float32."""
    cut2_rows = np.asarray(cut2_rows, np.float64)
    n = len(cut2_rows)
    padded = np.full(n_tiles(n) * TILE, -np.inf)
    padded[:n] = cut2_rows.astype(np.float32)
    return torch.as_tensor(padded.reshape(-1, TILE).max(1).astype(np.float32))


def mask_words(mask):
    """(n1, n_ct) int32: the static (n1, n2) mask packed as the row-tile
    kernels read it, bit l of word (i, ct) for pair (i, TILE * ct + l)
    (columns past n2 are 0)."""
    mask = np.asarray(mask, bool)
    n1, n2 = mask.shape
    padded = np.zeros((n1, n_tiles(n2) * TILE), bool)
    padded[:, :n2] = mask
    words = np.packbits(padded.reshape(n1, -1, TILE), axis=-1,
                        bitorder="little")
    return torch.as_tensor(np.ascontiguousarray(words).view("<i4")[..., 0])


def tile_boxes(x):
    """(lo, hi), each (B, n_t, 3): the per-replica box of each tile's sites
    x (B, n, >= 3); padded sites are left out."""
    B, n = x.shape[:2]
    pad = n_tiles(n) * TILE - n
    p = x[..., :3]
    lo = torch.cat([p, p.new_full((B, pad, 3), float("inf"))], 1)
    hi = torch.cat([p, p.new_full((B, pad, 3), float("-inf"))], 1)
    return (lo.reshape(B, -1, TILE, 3).amin(2),
            hi.reshape(B, -1, TILE, 3).amax(2))


def box_gap_sq(lo1, hi1, lo2, hi2):
    """Squared gap between boxes (broadcast), in the kernel's order."""
    g = torch.clamp(torch.maximum(lo1 - hi2, lo2 - hi1), min=0.0)
    gx, gy, gz = g.unbind(-1)
    return (gx * gx + gy * gy) + gz * gz


def tile_cull(x1, x2, thresholds, alive=None):
    """(B, n_rt, n_ct) bool: the (row tile, column tile) pairs of each
    replica that a row-tile kernel walks, for row sites x1 (B, n1, 6),
    column sites x2 (B, n2, 6) and the row tiles' squared thresholds
    (n_rt,) float32.  `alive` (n_rt, n_ct), the tiles whose static mask
    holds any pair, restricts it further (K4)."""
    with torch.no_grad():
        lo1, hi1 = tile_boxes(x1)
        lo2, hi2 = tile_boxes(x2)
        gap = box_gap_sq(lo1[:, :, None], hi1[:, :, None], lo2[:, None],
                         hi2[:, None])
        keep = ~(gap > thresholds.to(gap.device, torch.float32)[:, None])
        if alive is not None:
            keep = keep & alive.bool().to(keep.device)
        return keep


def pair_keep(keep, n1, n2):
    """(B, n1, n2) bool: the tile mask `keep` (B, n_rt, n_ct) spread to its
    pairs."""
    return keep.repeat_interleave(TILE, 1).repeat_interleave(
        TILE, 2)[:, :n1, :n2]


def flags_buffer(flags, shape, device):
    """The uint8 tile-flag buffer a row-tile kernel writes: the caller's
    (checked), else a new one."""
    if flags is None:
        return torch.empty(shape, dtype=torch.uint8, device=device)
    if tuple(flags.shape) != shape or flags.dtype != torch.uint8 or \
            flags.device != device or not flags.is_contiguous():
        raise ValueError(f"tile flags: expected contiguous uint8 {shape} on "
                         f"{device}")
    return flags


def no_flags(flags):
    """Refuses a tile-flag buffer where the plain version runs: it makes
    no cull, so it would leave the buffer unwritten."""
    if flags is not None:
        raise ValueError("tile flags are written by the CUDA kernel only")
