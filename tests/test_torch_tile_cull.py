"""The per-replica tile cull of the row-tile kernels (`ops/tile_cull.py`):
K3 and K4's and K5's forward and backward, on the CPU.

`tile_cull` is the plain version of the kernels' cull (csrc/pair_cull.cuh)
and gives their decisions bit for bit, so what holds here for it holds for
the kernels: it never drops a pair inside a cutoff (random layouts, pairs
at the cutoff +- 1e-5 A on tile corners, row tiles that straddle bands, n
not a multiple of 32, K5 on the rotamer grid's shape: one bead set on both
sides, the mask upper-triangular across residues), and the plain versions
restricted to the tiles it keeps equal the unrestricted ones exactly
(culled pairs contribute selected zeros).  The kernels themselves are held
to it on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import test_torch_kernels_cuda as kc
from upside_md_torch.ops import fused_pair as fp
from upside_md_torch.ops import quadspline as qs
from upside_md_torch.ops import tile_cull as tc

CPU = torch.device("cpu")
F32 = torch.float32


def fused_case(seed, env_band=True, step=3.8):
    return kc.fused_case(seed, env_band, step, CPU)


def spline_case(seed, step=3.8):
    return kc.spline_case(seed, step=step, device=CPU)


def spline_sites(shape, seed, step):
    """(ps, tab, x1, x2): K4's operands, or ("k5") K5's on the rotamer
    grid's shape, x1 and x2 one bead set."""
    if shape == "k5":
        ps, tab, x = kc.rotamer_case(seed, step=step, device=CPU)
        return ps, tab, x, x
    return spline_case(seed, step=step)[:4]


def _min_tile_dist(x1, x2):
    """(B, n_rt, n_ct) float64 least distance between any site of a row
    tile and any site of a column tile."""
    a, b = x1[..., :3].double(), x2[..., :3].double()
    d = torch.cdist(a, b)
    n_rt, n_ct = tc.n_tiles(a.shape[1]), tc.n_tiles(b.shape[1])
    pad = torch.full((d.shape[0], n_rt * tc.TILE, n_ct * tc.TILE),
                     float("inf"), dtype=d.dtype)
    pad[:, :d.shape[1], :d.shape[2]] = d
    return pad.reshape(-1, n_rt, tc.TILE, n_ct, tc.TILE).amin((2, 4))


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

def test_row_tile_thresholds_take_the_largest_band():
    """A row tile's threshold is its largest row cutoff; one row without a
    cutoff (env) leaves the tile unculled; padded rows do not count."""
    rows = np.array([4.0] * 30 + [9.0] * 5 + [np.inf] * 20 + [4.0] * 13)
    thr = tc.row_tile_thresholds(rows)
    assert thr.dtype == F32 and thr.tolist() == [9.0, np.inf, 4.0]
    prep, _ = fused_case(0)
    band = prep.band_of_rows()
    cov, pair = (float(np.float32(c)) for c in prep.cut2)
    for rt, t in enumerate(prep.tile_thresholds.tolist()):
        b = set(band[rt * 32:(rt + 1) * 32].tolist())
        want = np.inf if 2 in b else max(pair if 3 in b else 0.0,
                                          cov if b & {0, 1} else 0.0)
        assert t == want, (rt, b)
    assert cov < pair      # the pair family's cutoff is the wider one


@pytest.mark.parametrize("n2", [45, 64, 70])
def test_mask_words_pack_each_tile_row(n2):
    """Bit l of word (i, ct) is pair (i, 32 ct + l); past n2 it is 0; the
    fused block and the pair spline carry their masks so packed."""
    rng = np.random.default_rng(n2)
    mask = rng.random((37, n2)) > 0.4
    words = tc.mask_words(mask).numpy().astype(np.int64) & 0xFFFFFFFF
    assert words.shape == (37, tc.n_tiles(n2))
    bits = (words[:, :, None] >> np.arange(32)) & 1
    want = np.zeros((37, tc.n_tiles(n2) * 32), bool)
    want[:, :n2] = mask
    assert np.array_equal(bits.reshape(37, -1).astype(bool), want)
    prep, _ = fused_case(0)
    assert torch.equal(prep.mask_words, tc.mask_words(prep.mask.numpy()))
    ps = spline_case(0)[0]
    assert torch.equal(ps.mask_words, tc.mask_words(ps.mask.numpy()))


def test_tile_boxes_leave_out_padding():
    x = torch.zeros((2, 33, 6))
    x[:, :32, :3] = torch.arange(96.0).reshape(32, 3)
    x[:, 32, :3] = torch.tensor([-5.0, 7.0, 2.0])
    lo, hi = tc.tile_boxes(x)
    assert lo.shape == (2, 2, 3)
    assert lo[0, 0].tolist() == [0.0, 1.0, 2.0]
    assert hi[0, 0].tolist() == [93.0, 94.0, 95.0]
    assert lo[0, 1].tolist() == hi[0, 1].tolist() == [-5.0, 7.0, 2.0]


@pytest.mark.parametrize("seed,step", [(0, 3.8), (1, 6.0), (2, 9.0),
                                       (3, 14.0)])
def test_fused_cull_keeps_every_live_pair(seed, step):
    """K3's cull on chain layouts of several steps: no live pair of the
    spline bands lies in a culled tile, env row tiles are never culled,
    and every culled tile pair is farther apart than its threshold."""
    for env_band in (True, False):
        prep, (x1, _, x2, _) = fused_case(seed, env_band, step)
        keep = fp.cull_tiles(prep, x1, x2)
        assert keep.shape == (3, tc.n_tiles(prep.n1), tc.n_tiles(prep.n2))
        live = kc.fused_live(prep, x1, x2)
        assert live.any()
        assert not (live & ~tc.pair_keep(keep, prep.n1, prep.n2)).any()
        env_tiles = torch.isinf(prep.tile_thresholds)
        assert bool(env_tiles.any()) == env_band
        assert keep[:, env_tiles].all()
        far = _min_tile_dist(x1, x2)
        cut = (prep.tile_thresholds.double().sqrt() - tc.CULL_MARGIN)[
            None, :, None].expand_as(far)
        assert (far[~keep] > cut[~keep]).all()
        if step >= 9.0:
            assert not keep[:, ~env_tiles].all()    # the cull does cull


@pytest.mark.parametrize("seed,step,shape", [
    pytest.param(seed, step, shape,
                 id=f"{seed}-{step}" if shape == "k4" else f"k5-{seed}-{step}")
    for shape in ("k4", "k5") for seed, step in ((0, 3.8), (1, 6.0),
                                                 (2, 12.0))])
def test_spline_cull_keeps_every_live_pair(seed, step, shape):
    """K4's cull, and K5's on the rotamer grid's shape: no live pair in a
    culled tile, the static mask's empty tiles culled too, culled tile
    pairs farther apart than the cutoff."""
    ps, tab, x1, x2 = spline_sites(shape, seed, step)
    ps.tile_alive[1, 0] = 0             # as if the mask emptied that tile
    ps.mask[32:64, 0:32] = 0
    keep = qs.cull_tiles(ps, tab, x1, x2)
    live = qs.live_pairs(ps, tab, x1, x2)
    assert live.any()
    assert not (live & ~tc.pair_keep(keep, ps.n1, ps.n2)).any()
    assert not keep[:, 1, 0].any()
    far = _min_tile_dist(x1, x2)
    dist_culled = far[~keep & ps.tile_alive.bool()[None]]
    assert (dist_culled > tab.kcut / tab.inv_dx).all()
    if step >= 12.0:
        assert dist_culled.numel() > 0


@pytest.mark.parametrize("offset", [-1e-5, 1e-5])
@pytest.mark.parametrize("direction", [(1.0, 0.0, 0.0), (1.0, 1.0, 1.0),
                                       (0.3, 1.0, 0.6)])
def test_pairs_at_the_cutoff_on_tile_corners(offset, direction):
    """A row site and a column site at the cutoff +- 1e-5 A, on the first
    and last rows and columns of their tiles (ragged last tiles too): the
    tile pair is kept (a pair just inside is live; the margin keeps the
    one just outside too), and at twice the margin beyond the cutoff it
    is culled.  For K4, for K3's pair and coverage bands, and for K5 on
    the rotamer grid's shape (one bead set, sites i < j of different
    residues)."""
    u = np.array(direction) / np.linalg.norm(direction)
    p = np.array([3.0, -2.0, 7.5])
    n1, n2 = 70, 45
    ps = qs.PairSpline(np.zeros(n1, int), np.zeros(n2, int),
                       np.ones((n1, n2), bool), CPU)
    tab = ps.table(torch.zeros((1, 1, 34)))
    prep, _ = fused_case(0, env_band=False)
    assert prep.r_b == 40 and prep.r_p == 77 and prep.n1 == 147

    def two_sets(m1, m2):
        return lambda i, j, q: kc.corner_layout(m1, m2, i, j, p, q, CPU)

    cases = [(lambda x1, x2: qs.cull_tiles(ps, tab, x1, x2),
              lambda x1, x2: qs.live_pairs(ps, tab, x1, x2),
              two_sets(n1, n2), tab.kcut / tab.inv_dx, ij)
             for ij in ((31, 32), (32, 31), (64, 0), (69, 44), (0, 44))]
    # K3: inside the row's own band cutoff, whatever its mask says
    cases += [(lambda x1, x2: fp.cull_tiles(prep, x1, x2),
               lambda x1, x2, k=kcut: fp._geometry(x1, x2)[1]
               * prep.inv_dx < k, two_sets(prep.n1, prep.n2),
               kcut / prep.inv_dx, ij)
              for kcut, ijs in (
                  (prep.kcut_pair, ((95, 31), (96, 32), (146, 69),
                                    (127, 0))),
                  (prep.kcut_cov, ((0, 31), (31, 32), (32, 69))))
              for ij in ijs]
    # K5: one bead set on both sides, two beads a residue
    ps5 = qs.PairSpline(np.zeros(n1, int), np.zeros(n1, int),
                        kc.rotamer_mask(np.arange(n1) // 2), CPU)
    tab5 = ps5.table(torch.zeros((1, 1, 34)))

    def one_set(i, j, q):
        x = kc.corner_layout_one(n1, i, j, p, q, CPU)
        return x, x

    cases += [(lambda x1, x2: qs.cull_tiles(ps5, tab5, x1, x2),
               lambda x1, x2: qs.live_pairs(ps5, tab5, x1, x2),
               one_set, tab5.kcut / tab5.inv_dx, ij)
              for ij in ((31, 32), (0, 44), (32, 69), (63, 64))]
    for cull, live, layout, cut, (i, j) in cases:
        for beyond in (0.0, 2 * tc.CULL_MARGIN):
            x1, x2 = layout(i, j, p + (cut + offset + beyond) * u)
            keep = cull(x1, x2)
            assert bool(keep[0, i // 32, j // 32]) == (beyond == 0.0), \
                (i, j, beyond)
            assert bool(live(x1, x2)[0, i, j]) == (offset < 0
                                                   and beyond == 0.0)


def test_cull_differs_between_replicas():
    """Each replica has its own boxes: one compact, one spread apart."""
    ps, tab, x1, x2, _ = kc.spline_case(4, n_rep=2, device=CPU,
                                        steps=[0.02, 20.0])
    keep = qs.cull_tiles(ps, tab, x1, x2)
    assert keep[0].all() and not keep[1].all()
    live = qs.live_pairs(ps, tab, x1, x2)
    assert not (live & ~tc.pair_keep(keep, ps.n1, ps.n2)).any()


# ---------------------------------------------------------------------------
# the plain backwards restricted to the kept tiles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env_band", [True, False])
@pytest.mark.parametrize("step", [3.8, 12.0])
def test_restricted_k3_plain_is_exact(env_band, step):
    prep, x = fused_case(5, env_band, step)
    keep = fp.cull_tiles(prep, x[0], x[2])
    gen = torch.Generator().manual_seed(3)
    fwd = fp.fused_pair_fwd(prep, *x, want_planes=False)
    g = [torch.randn(t.shape, generator=gen) for t in fwd[:3]]
    full = fp.fused_pair_bwd_recompute(prep, *x, *g)
    cut = fp.fused_pair_bwd_recompute_plain(prep, *x, *g, keep=keep)
    assert all(torch.equal(a, b) for a, b in zip(full, cut))
    assert full[0].abs().max() > 0
    if step > 10.0:
        assert not keep.all()
    # dropping a tile with live pairs does change the result
    lk = tc.pair_keep(keep, prep.n1, prep.n2) & kc.fused_live(prep, x[0], x[2])
    b, i, j = (int(v[0]) for v in torch.nonzero(lk, as_tuple=True))
    fewer = keep.clone()
    fewer[b, i // 32, j // 32] = False
    less = fp.fused_pair_bwd_recompute_plain(prep, *x, *g, keep=fewer)
    assert not torch.equal(less[0], full[0])


@pytest.mark.parametrize("kernel,step", [
    pytest.param(kernel, step,
                 id=str(step) if kernel == "k4_bwd" else f"{kernel}-{step}")
    for kernel in ("k4_bwd", "k4_fwd", "k5_bwd") for step in (3.8, 12.0)])
def test_restricted_k4_plain_is_exact(kernel, step):
    """The plain K4 backward and forward and K5 backward (on the rotamer
    grid's shape) restricted to the tiles `cull_tiles` keeps equal the
    unrestricted ones bit for bit; at the wide step the cull drops tiles
    the static mask holds pairs in."""
    gen = torch.Generator().manual_seed(1)
    if kernel == "k5_bwd":
        ps, tab, x1, x2 = spline_sites("k5", 6, step)
        g = torch.randn((x1.shape[0], ps.n1, ps.n2), generator=gen)
        full = qs.quadspline_bwd(ps, tab, x1, x2, g)
        cut = qs.quadspline_bwd_plain(ps, tab, x1, x2, g,
                                      keep=qs.cull_tiles(ps, tab, x1, x2))
    else:
        ps, tab, x1, x2, w1 = spline_case(6, step=step)
        keep = qs.cull_tiles(ps, tab, x1, x2)
        if kernel == "k4_fwd":
            full = (qs.colsum_fwd(ps, tab, x1, x2, w1),)
            cut = (qs.colsum_fwd_plain(ps, tab, x1, x2, w1, keep=keep),)
        else:
            g = torch.randn((x1.shape[0], ps.n2), generator=gen)
            full = qs.colsum_bwd(ps, tab, x1, x2, w1, g)
            cut = qs.colsum_bwd_plain(ps, tab, x1, x2, w1, g, keep=keep)
            assert full[0][..., 6].abs().max() > 0
    keep = qs.cull_tiles(ps, tab, x1, x2)
    assert all(torch.equal(a, b) for a, b in zip(full, cut))
    assert all(a.abs().max() > 0 for a in full)
    if step > 10.0:
        assert not keep[:, ps.tile_alive.bool()].all()


@pytest.mark.parametrize("shape,seed,step", [
    (shape, seed, step) for shape in ("k5", "k4")
    for seed, step in ((6, 3.8), (7, 6.0), (8, 12.0))])
def test_restricted_k5_fwd_plain_is_exact(shape, seed, step):
    """The plain K5 forward restricted to the tiles `cull_tiles` keeps
    equals the unrestricted grid bit for bit, on the rotamer grid's shape
    (one bead set, "k5") and on two site sets with a random mask ("k4"
    operands); at the wide step the cull drops tiles the static mask
    holds pairs in, and dropping a tile with a live pair does change the
    grid."""
    ps, tab, x1, x2 = spline_sites(shape, seed, step)
    keep = qs.cull_tiles(ps, tab, x1, x2)
    full = qs.quadspline_fwd(ps, tab, x1, x2)
    assert torch.equal(full, qs.quadspline_fwd_plain(ps, tab, x1, x2,
                                                     keep=keep))
    live = qs.live_pairs(ps, tab, x1, x2)
    assert torch.equal(full != 0, live)
    if step > 10.0:
        assert not keep[:, ps.tile_alive.bool()].all()
    b, i, j = (int(v[0]) for v in torch.nonzero(live, as_tuple=True))
    fewer = keep.clone()
    fewer[b, i // 32, j // 32] = False
    assert not torch.equal(full, qs.quadspline_fwd_plain(ps, tab, x1, x2,
                                                         keep=fewer))


@pytest.mark.parametrize("shape", ["k5", "k4"])
def test_restricted_k5_fwd_plain_at_the_cutoff(shape):
    """Pairs at the cutoff +- 1e-5 A on the facing corners of their tiles
    (the card tests' at_cutoff layouts, one replica each): the plain K5
    forward restricted to `cull_tiles` equals the unrestricted grid bit
    for bit, the pair just inside is live and has its value, the one just
    outside is 0; on the rotamer grid's shape and on two site sets."""
    if shape == "k5":
        ps, tab, x1, x2 = kc._k5_layout("at_cutoff", CPU)
        corners = kc.K5_CORNERS
    else:
        ps, tab, x1, x2, _ = kc._k4_layout("at_cutoff", CPU)
        corners = kc.K4_CORNERS
    keep = qs.cull_tiles(ps, tab, x1, x2)
    full = qs.quadspline_fwd(ps, tab, x1, x2)
    assert torch.equal(full, qs.quadspline_fwd_plain(ps, tab, x1, x2,
                                                     keep=keep))
    live = qs.live_pairs(ps, tab, x1, x2)
    for r, (i, j, off) in enumerate(corners):
        assert bool(keep[r, i // 32, j // 32])
        assert bool(live[r, i, j]) == (off < 0)
        assert (full[r, i, j] != 0) == (off < 0)
    assert torch.equal(full != 0, live)


def test_flags_buffer_checks_the_callers_buffer():
    shape = (2, 3, 4)
    assert tc.flags_buffer(None, shape, CPU).shape == shape
    mine = torch.zeros(shape, dtype=torch.uint8)
    assert tc.flags_buffer(mine, shape, CPU) is mine
    for bad in (torch.zeros((2, 3, 5), dtype=torch.uint8),
                torch.zeros(shape, dtype=torch.int32)):
        with pytest.raises(ValueError):
            tc.flags_buffer(bad, shape, CPU)
    # the plain versions make no cull and refuse a buffer they cannot fill
    tc.no_flags(None)
    with pytest.raises(ValueError):
        tc.no_flags(mine)
