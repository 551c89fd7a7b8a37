"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.

Every test is marked `requires_cuda` and skips where
`torch.cuda.is_available()` is False.  The module imports no JAX, so it
runs on the GPU machine too, without the JAX conftest:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Problems are seeded numpy, float32, several replicas that differ, and span
several 32x32 tiles with ragged edges so the per-tile partial sums are
exercised.  Tolerances: K1, K4 and K5 forward rel 1e-5 and backward (K3
too) rel 1e-4 (f32, two summation orders); K1's compact residual: counts
and codes equal to `pack_residuals` of the plain forward, values rel 1e-5; K2 and K6 at the BP tol of
`bp_cases` (1e-4), rel 1e-4, sweep counts equal to the plain solve's, the
compact edge list and its indices equal to `compact_edges`, each case in
the layout of the solve its edge count calls for (messages and factors in
shared memory, messages only, global scratch); and again at BP tol 1e-6,
values rel 1e-4 (there float32 rounding of the deviation decides the stop,
so sweep counts are not compared).  Kernels must be bitwise repeatable.
K1, K3 and K4's and K5's forward and backward, the row-tile kernels
with the per-replica cull, are also run on layouts that cull every tile,
none, different tiles in different replicas, and hold pairs at the cutoff
+- 1e-5 A on tile corners (K5 on the rotamer grid's shape: one bead set
on both sides, the mask upper-triangular across residues): against the
plain versions as above, their tile decisions equal to `cull_tiles`,
NaN/Inf in dead and culled slots (cotangents, K4's row weights) leaving
the results unmoved; K5's forward, launched into a grid filled with NaN,
must overwrite every element.
The layouts (chain-ordered sites, corner pairs) serve the CPU tests of the
cull too (tests/test_torch_tile_cull.py).  A Hamiltonian ensemble's
stacked table launches the fused block once a slot: bitwise equal to one
batched launch over identical slots; and K2 started cold (null warm-start
pointers, as the energy-only evaluations of MC moves and replica swaps
start it) after a warm call equals its first cold call bit for bit and
the plain cold solve.  T4 lysozyme and GFP, past 128 residues and
1,024 beads, evaluate on the card (K6 not launched, GFP only
`gather_rows_bwd`) and match the port on the CPU in float64 at rel 1e-3.
The spline tables' cotangent (`table_cotangent`, csrc/table_cotangent.cu)
against its plain version in each of the five families at rel 1e-4, at
1 and 37 replicas; pairs at the
cutoff +- 1e-5 A taken or left as the plain version takes them; NaN/Inf
in g at masked and past-cutoff slots leaving it unmoved bit for bit; the
pair band's strided grid read in place; bitwise repeatable; one launch a
band of the fused block, none with `plain`; T4 lysozyme's table
gradients through K4 and K5 (`quadspline._table_grad`) with kernels
against `kernels=False` at rel 1e-3.
The neighbour lists' pair spline (`nlist_spline_fwd`, `nlist_spline_bwd`,
csrc/nlist_spline.cu, through `pairs.quadspline_coverage_nl`) against
`plain=True` (the window-weight chain): values rel 1e-5, position and
direction gradients and the table's gradient rel 1e-4 (Horner and the
window weights round differently); in each of the five families at 1
and 37 replicas with rows that overflow K (the same partners kept), on
the rotamer grid's shape (one bead set both sides), and on GFP's three
lists at their own shapes (rotamer grid 1,143 x 1,143, K 128; coverages
464 and 714 x 1,143, K 96); bitwise repeatable; NaN/Inf in the cotangent
at dead slots and out-of-range indices off the mask leaving the results
unmoved bit for bit; a float64 CUDA input refused.
"""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from upside_md_torch import DATA_DIR
from upside_md_torch.ops import bp_cases
from upside_md_torch.ops import bp_pairs as bp
from upside_md_torch.ops import bp_planes as bpp
from upside_md_torch.ops import fused_pair as fp
from upside_md_torch.ops import pairs
from upside_md_torch.ops import quadspline as qs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain on the card)")
    return torch.device("cuda", 0)


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


def _sites(rng, n, spread):
    d = rng.normal(size=(n, 3))
    return np.concatenate([spread * rng.normal(size=(n, 3)),
                           d / np.linalg.norm(d, axis=-1, keepdims=True)], 1)


def fused_problem(rng, n_a=40, n_b=37, n_e=9, n2=70, ka=8, kc=7, kp=9,
                  n_rep=3):
    tabs = [0.3 * rng.normal(size=(A, 5, 2 * ka + 2 * k))
            for A, k in ((2, kc), (3, kc), (5, kp))]
    types1 = [rng.integers(0, 2, n_a), rng.integers(0, 3, n_b),
              rng.integers(0, 3, n_e), rng.integers(0, 5, n2)]
    types2 = [types1[3], types1[3], rng.integers(0, 4, n2), types1[3]]
    res = rng.integers(0, 25, n2)
    masks = [rng.random((n, n2)) > 0.2 for n in (n_a, n_b, n_e)]
    masks.append((np.arange(n2)[:, None] < np.arange(n2)[None, :])
                  & (res[:, None] != res[None, :]))
    env = np.stack([rng.uniform(1.0, 4.0, (3, 4)), rng.uniform(0.5, 2.0, (3, 4)),
                    rng.uniform(-0.5, 0.5, (3, 4)),
                    rng.uniform(0.5, 2.0, (3, 4))], -1)
    base = _sites(rng, n_a + n_b + n_e + n2, 5.0)
    x1 = np.stack([base + 0.3 * np.concatenate(
        [rng.normal(size=(len(base), 3)), np.zeros((len(base), 3))], 1)
        for _ in range(n_rep)])
    w1 = np.concatenate([rng.uniform(0.1, 1.0, (n_rep, n_a + n_b)),
                         np.zeros((n_rep, n_e + n2))], 1)
    x2 = x1[:, n_a + n_b + n_e:]
    wcol = rng.uniform(0.1, 1.5, (n_rep, n2))
    return tabs, types1, types2, masks, env, (x1, w1, x2, wcol)


def walk(rng, n, step, persist=0.6):
    """(n, 3) a random walk of n steps of `step` A, each step's direction
    leaning `persist` on the last one (a stiff chain)."""
    d = rng.normal(size=(n, 3))
    for a in range(1, n):
        d[a] = persist * d[a - 1] / np.linalg.norm(d[a - 1]) \
            + (1 - persist) * d[a] / np.linalg.norm(d[a])
    return np.cumsum(step * d / np.linalg.norm(d, axis=-1, keepdims=True), 0)


def chain_sites(rng, path, n, n_rep, jitter=0.3):
    """(n_rep, n, 6) sites spread along `path` (m, 3) in order, each
    replica jittered on its own, with random unit directions: rows and
    columns of neighbouring indices lie close, as along a protein."""
    idx = np.linspace(0, len(path) - 1, n).round().astype(int)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.stack([np.concatenate(
        [path[idx] + jitter * rng.normal(size=(n, 3)), d], 1)
        for _ in range(n_rep)])


def _f32(a, device):
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)


def fused_case(seed, env_band, step, device, n_rep=3, steps=None):
    """A fused block (prep, (x1, w1, x2, wcol)) of `fused_problem`'s
    tables, whose band edges (40, 77, 86) and n2 = 70 fall inside tiles;
    the beads follow a random walk of `step` A (or, per replica, of
    `steps`), and each band's rows lie along it."""
    rng = np.random.default_rng(seed)
    tabs, t1, t2, masks, env, dyn = fused_problem(rng, n_rep=n_rep)
    _, w1, _, wcol = dyn
    steps = steps or [step] * n_rep
    paths = [walk(rng, len(t1[3]), st) for st in steps]
    x1 = np.concatenate([np.concatenate([chain_sites(rng, path, len(t), 1)
                                         for t in t1], 1) for path in paths])
    if not env_band:
        n_e = len(t1[2])
        t1[2], t2[2], masks[2], env = t1[2][:0], 0 * t2[2], masks[2][:0], None
        keep = np.ones(x1.shape[1], bool)
        keep[len(t1[0]) + len(t1[1]):][:n_e] = False
        x1, w1, wcol = x1[:, keep], w1[:, keep], 0 * wcol
    prep = fp.make_prep(tabs, t1, t2, masks, env, device, torch.float32)
    x1 = _f32(x1, device)
    return prep, (x1, _f32(w1, device), x1[:, prep.r_p:].contiguous(),
                  _f32(wcol, device))


def fused_live(prep, x1, x2):
    """(B, n1, n2) the live pairs of the fused block's spline bands: mask
    and s = dist / dx below the band's cutoff."""
    with torch.no_grad():
        dist = fp._geometry(x1, x2)[1]
        band = prep.band_of_rows()
        kcut = torch.where(band == 3, prep.kcut_pair, prep.kcut_cov)
        return prep.mask.bool() & (band != 2)[:, None] & \
            (dist * prep.inv_dx < kcut[:, None])


def spline_case(seed, n1=100, n2=135, n_t=4, ka=8, k=9, n_rep=3, step=3.8,
                device=None, steps=None):
    """K4's operands (ps, tab, x1, x2, w1): columns along a random walk of
    `step` A (or, per replica, of `steps`), rows along the same walk."""
    rng = np.random.default_rng(seed)
    table = _f32(0.5 * rng.normal(size=(n_t, n_t + 1, 2 * ka + 2 * k)),
                 device)
    t1, t2 = rng.integers(0, n_t, n1), rng.integers(0, n_t + 1, n2)
    mask = rng.random((n1, n2)) > 0.2
    steps = steps or [step] * n_rep
    x1, x2 = [], []
    for st in steps:
        path = walk(rng, n2, st)
        x1.append(chain_sites(rng, path, n1, 1))
        x2.append(chain_sites(rng, path, n2, 1))
    w1 = _f32(rng.uniform(0.1, 1.0, (n_rep, n1)), device)
    ps = qs.PairSpline(t1, t2, mask, device)
    return (ps, ps.table(table), _f32(np.concatenate(x1), device),
            _f32(np.concatenate(x2), device), w1)


def rotamer_mask(res):
    """(n, n) bool: the rotamer grid's mask, upper-triangular across
    residues (nodes/rotamer.py)."""
    res = np.asarray(res)
    idx = np.arange(len(res))
    return (idx[:, None] < idx[None, :]) & (res[:, None] != res[None, :])


def rotamer_case(seed, n=135, n_t=4, ka=8, k=9, n_rep=3, step=3.8,
                 device=None, steps=None):
    """K5's operands on the rotamer grid's shape (ps, tab, x): one bead
    set x (B, n, 6) for rows and columns, two beads a residue, the mask
    upper-triangular across residues, the beads spread along a random
    walk of n / 2 steps of `step` A (or, per replica, of `steps`), about
    two a step, so that neighbouring residues lie close at any step."""
    rng = np.random.default_rng(seed)
    table = _f32(0.5 * rng.normal(size=(n_t, n_t, 2 * ka + 2 * k)), device)
    t = rng.integers(0, n_t, n)
    steps = steps or [step] * n_rep
    x = np.concatenate([chain_sites(rng, walk(rng, n // 2, st), n, 1)
                        for st in steps])
    ps = qs.PairSpline(t, t, rotamer_mask(np.arange(n) // 2), device)
    return ps, ps.table(table), _f32(x, device)


def corner_layout(n1, n2, i, j, p, q, device, seed=0):
    """(x1 (1, n1, 6), x2 (1, n2, 6)): row i sits at p and column j at q,
    at the facing corners of their tiles' boxes: the other sites of i's
    tile lie at or below p on every axis, those of j's tile at or above q
    (p <= q), and every other tile 1000 A away."""
    rng = np.random.default_rng(seed)
    x1 = np.zeros((n1, 6))
    x2 = np.zeros((n2, 6))
    x1[:, 3] = x2[:, 3] = 1.0
    x1[:, :3] = 1000.0 * (1 + np.arange(n1) // 32)[:, None]
    x2[:, :3] = -1000.0 * (1 + np.arange(n2) // 32)[:, None]
    ri = np.arange(n1) // 32 == i // 32
    cj = np.arange(n2) // 32 == j // 32
    x1[ri, :3] = p - np.abs(rng.normal(0.0, 2.0, (ri.sum(), 3)))
    x2[cj, :3] = q + np.abs(rng.normal(0.0, 2.0, (cj.sum(), 3)))
    x1[i, :3], x2[j, :3] = p, q
    return _f32(x1[None], device), _f32(x2[None], device)


def corner_layout_one(n, i, j, p, q, device, seed=0):
    """x (1, n, 6), one site set for rows and columns (K5's rotamer
    grid): site i at p and site j at q, of different tiles, at the facing
    corners of their tiles' boxes as in `corner_layout`; each other tile's
    sites at one point, 1000 A from the others."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, 6))
    x[:, 3] = 1.0
    x[:, :3] = 1000.0 * (1 + np.arange(n) // 32)[:, None]
    ri = np.arange(n) // 32 == i // 32
    cj = np.arange(n) // 32 == j // 32
    x[ri, :3] = p - np.abs(rng.normal(0.0, 2.0, (ri.sum(), 3)))
    x[cj, :3] = q + np.abs(rng.normal(0.0, 2.0, (cj.sum(), 3)))
    x[i, :3], x[j, :3] = p, q
    return _f32(x[None], device)


@pytest.mark.requires_cuda
def test_fused_kernels_match_plain(cuda):
    """The fused block through K1's kernels (forward, compact residual,
    backward) against its plain version: the outputs, and the input
    gradients of the forward-backward round trip under a random
    cotangent."""
    tabs, t1, t2, masks, env, dyn = fused_problem(np.random.default_rng(0))
    prep = fp.make_prep(tabs, t1, t2, masks, env, cuda, torch.float32)
    gen = torch.Generator(device=cuda).manual_seed(1)
    grads, outs = [], []
    for plain in (False, True):
        x = [torch.tensor(a, dtype=torch.float32, device=cuda,
                          requires_grad=True) for a in dyn]
        out = fp.fused_pair_block(prep, *x, plain=plain)
        if not grads:
            g = [torch.randn(t.shape, generator=gen, device=cuda)
                 for t in out]
        sum((a * b).sum() for a, b in zip(out, g)).backward()
        outs.append([t.detach() for t in out])
        grads.append([t.grad for t in x])
    for a, b in zip(*outs):
        assert _rel(a, b) < 1e-5
    for a, b in zip(*grads):
        assert torch.isfinite(a).all() and _rel(a, b) < 1e-4
    assert outs[0][1].count_nonzero() > 10 and outs[0][2].count_nonzero() > 3


def _k1_against_plain(prep, x, seed, first=slice(None)):
    """K1's forward and backward kernels on (prep, x) against their plain
    versions on the replicas `first`: cov, E_pair and env rel 1e-5; the
    residual's counts and codes equal to `pack_residuals` of the plain
    forward and its values rel 1e-5; the cull's decisions equal to
    `cull_tiles`; the backward from the kernel's residual rel 1e-4 against
    the plain one from the dense planes; both bitwise repeatable twice
    over.  Returns (the kernel forward, cotangents, backward, flags)."""
    from upside_md_torch.ops import tile_cull as tc
    B = x[0].shape[0]
    flags = torch.full((B, tc.n_tiles(prep.n1), tc.n_tiles(prep.n2)), 7,
                       dtype=torch.uint8, device=x[0].device)
    k = fp.fused_pair_fwd(prep, *x, flags=flags)
    valid = fp.residual_slots(k[3].counts)
    for _ in range(2):
        again = fp.fused_pair_fwd(prep, *x)
        assert all(torch.equal(a, b) for a, b in zip(k[:3], again[:3]))
        assert torch.equal(k[3].counts, again[3].counts)
        assert torch.equal(k[3].codes[valid], again[3].codes[valid])
        assert torch.equal(k[3].vals[valid], again[3].vals[valid])
    xf = [t[first] for t in x]
    p = fp.fused_pair_fwd(prep, *xf, plain=True)
    for a, b in zip(k[:3], p[:3]):
        if b.numel():
            assert _rel(a[first], b) < 1e-5
    keep = fp.cull_tiles(prep, x[0], x[2])
    assert torch.equal((flags & tc.KEPT) != 0, keep)
    want = fp.pack_residuals(prep, xf[0], xf[2], *p[3])
    vf = valid[first]
    assert torch.equal(k[3].counts[first], want.counts)
    assert torch.equal(k[3].codes[first][vf], want.codes[vf])
    if vf.any():
        assert _rel(k[3].vals[first][vf], want.vals[vf]) < 1e-5
    gen = torch.Generator(device=x[0].device).manual_seed(seed)
    g = [torch.randn(t.shape, generator=gen, device=x[0].device)
         for t in k[:3]]
    bk = fp.fused_pair_bwd(prep, *x, k[3], *g)
    for _ in range(2):
        assert all(torch.equal(a, b) for a, b in zip(
            bk, fp.fused_pair_bwd(prep, *x, k[3], *g)))
    _check_rows([t[first] for t in bk], fp.fused_pair_bwd(
        prep, *xf, p[3], *(t[first] for t in g), plain=True))
    return k, g, bk, flags


@pytest.mark.requires_cuda
@pytest.mark.parametrize("env_band", [True, False])
def test_recomputing_backward_matches_plain(cuda, env_band):
    """K3 and the forward without planes, with and without the env band;
    non-finite cotangents in dead slots (the padded grid, an all-masked env
    row, a coverage column no hbond row reaches) leave K3's result as it
    was."""
    tabs, t1, t2, masks, env, dyn = fused_problem(np.random.default_rng(2))
    masks[0][:, 5] = False
    masks[2][1] = False
    x1, w1, x2, wcol = (torch.tensor(a, dtype=torch.float32, device=cuda)
                        for a in dyn)
    if not env_band:
        n_e = len(t1[2])
        t1[2], t2[2], masks[2], env = t1[2][:0], 0 * t2[2], masks[2][:0], None
        keep = torch.ones(x1.shape[1], dtype=torch.bool, device=cuda)
        keep[len(t1[0]) + len(t1[1]):][:n_e] = False
        x1, w1, wcol = x1[:, keep], w1[:, keep], torch.zeros_like(wcol)
    prep = fp.make_prep(tabs, t1, t2, masks, env, cuda, torch.float32)
    k = fp.fused_pair_fwd(prep, x1, w1, x2, wcol, want_planes=False)
    p = fp.fused_pair_fwd(prep, x1, w1, x2, wcol, plain=True,
                          want_planes=False)
    assert k[3] is None
    for a, b in zip(k[:3], p[:3]):
        if b.numel():
            assert _rel(a, b) < 1e-5
    gen = torch.Generator(device=cuda).manual_seed(3)
    g = [torch.randn(t.shape, generator=gen, device=cuda) for t in p[:3]]
    bk = fp.fused_pair_bwd_recompute(prep, x1, w1, x2, wcol, *g)
    assert all(torch.equal(a, b) for a, b in zip(
        bk, fp.fused_pair_bwd_recompute(prep, x1, w1, x2, wcol, *g)))
    bp_ = fp.fused_pair_bwd_recompute(prep, x1, w1, x2, wcol, *g,
                                      plain=True)
    for a, b in zip(bk, bp_):
        assert _rel(a, b) < 1e-4
    g_cov, g_grid, g_env = (t.clone() for t in g)
    g_grid[:, prep.n2:] = float("nan")
    g_grid[:, :, prep.n2:] = float("inf")
    g_cov[:, 0, 5] = float("nan")
    g_env[:, 1:2] = float("nan")
    dirty = fp.fused_pair_bwd_recompute(prep, x1, w1, x2, wcol, g_cov,
                                        g_grid, g_env)
    g_cov[:, 0, 5] = 0.0
    g_env[:, 1:2] = 0.0
    clean = fp.fused_pair_bwd_recompute(prep, x1, w1, x2, wcol, g_cov,
                                        g[1], g_env)
    for a, b in zip(dirty, clean):
        assert torch.isfinite(a).all() and torch.equal(a, b)


def _check_bp(run, plain, adj_of, want_layout):
    """K2 or K6 against its plain version, cold and then warm from the cold
    solution on the problem with E1 scaled by `bp_cases.WARM_SCALE`:
    `run(scale, init, tol)` -> (outputs, scratch), `plain(scale, init,
    tol)` -> outputs, `adj_of()` the dense adjacency.  At the cases' BP
    tol: sweep counts equal, F, the gradients, the beliefs and the dense
    messages rel 1e-4, bitwise repeatable twice over, the compact edge
    list equal to `compact_edges`, the layout of each replica's solve the
    one `solve_layout` gives and `want_layout` among them.  At
    `bp_cases.TIGHT_TOL` the same values rel 1e-4.  Returns the cold sweep
    counts."""
    tol = bp_cases.BP_SETTINGS[2]
    cold_iters = None
    init = None
    for start, scale in (("cold", 1.0), ("warm", bp_cases.WARM_SCALE)):
        k, sc = run(scale, init, tol)
        for _ in range(2):
            again, _ = run(scale, init, tol)
            assert all(torch.equal(a, b) for a, b in zip(k, again)), start
        p = plain(scale, init, tol)
        assert k[6].tolist() == p[6].tolist(), start
        for i in range(5):          # F, gradients, beliefs, messages
            assert _rel(k[i], p[i]) < 1e-4, (start, i)
        kt, _ = run(scale, init, bp_cases.TIGHT_TOL)
        pt = plain(scale, init, bp_cases.TIGHT_TOL)
        assert (kt[6] >= k[6]).all()
        for i in range(5):
            assert _rel(kt[i], pt[i]) < 1e-4, (start, "tight", i)
        counts = sc.counts.cpu()
        # K2 keeps one factor block per undirected pair, K6 per edge
        shared = sc.factors.shape[1] < sc.edges.shape[1]
        n_edges = counts[:, 0]
        n_blocks = counts[:, 1] if shared else n_edges
        want = [bp.solve_layout(int(e), int(f))
                for e, f in zip(n_edges, n_blocks)]
        assert counts[:, 2].tolist() == want and max(want) == want_layout
        cnt, edges, rev, pair = bp.compact_edges(adj_of())
        assert n_edges.tolist() == cnt.tolist()
        for r, n in enumerate(cnt.tolist()):
            assert torch.equal(sc.edges[r, :n], edges[r, :n])
            assert torch.equal(sc.reverse[r, :n], rev[r, :n])
            if shared:
                assert torch.equal(sc.pair_index[r, :n], pair[r, :n])
        if cold_iters is None:
            cold_iters = k[6].tolist()
        init = (k[3], k[4])
    return cold_iters


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", list(bp_cases.PAIRS_CASES))
def test_bp_kernel_matches_plain(cuda, case):
    """K2 on a mixed batch (replicas that take different sweep counts, one
    without any edge, a residue without a neighbour, invalid slots)."""
    kw = bp_cases.PAIRS_CASES[case]
    E1, E, res, rot, valid, n2p = bp_cases.pairs_case(**bp_cases.MIXED, **kw)
    st = bp.make_statics(res, rot, valid, n2p, *bp_cases.BP_SETTINGS, cuda)
    assert st.slot_beads.shape[1] == kw["m_slot"]
    f32 = dict(dtype=torch.float32, device=cuda)
    e1, ep = torch.tensor(E1, **f32), torch.tensor(E, **f32)

    def adj_of():
        eye = torch.eye(st.n_res, dtype=torch.bool, device=cuda)
        return (bp.scatter_pairs(st, ep) != 0).any(-1).any(-1) & ~eye

    iters = _check_bp(
        lambda c, init, tol: bp.bp_pairs_kernel(
            dataclasses.replace(st, tol=tol), c * e1, ep, init),
        lambda c, init, tol: bp.bp_bethe_pairs_fwd(
            dataclasses.replace(st, tol=tol), c * e1, ep, init, plain=True),
        adj_of, bp_cases.CASE_LAYOUT.get(case, 0))
    assert len(set(iters)) > 1 and not adj_of()[2].any()
    assert not adj_of()[:, 3].any()


def _repeatable(fn):
    a, b = fn(), fn()
    a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    return a


@pytest.mark.requires_cuda
def test_pair_spline_kernels_match_plain(cuda):
    rng = np.random.default_rng(2)
    n1, n2, n_t, ka, k, n_rep = 75, 70, 4, 8, 9, 3
    table = torch.tensor(0.5 * rng.normal(size=(n_t, n_t + 1, 2 * ka + 2 * k)),
                         dtype=torch.float32, device=cuda)
    t1, t2 = rng.integers(0, n_t, n1), rng.integers(0, n_t + 1, n2)
    mask = rng.random((n1, n2)) > 0.2

    def batch(n):
        base = _sites(rng, n, 3.0)
        return torch.tensor(np.stack([base + 0.2 * np.concatenate(
            [rng.normal(size=(n, 3)), np.zeros((n, 3))], 1)
            for _ in range(n_rep)]), dtype=torch.float32, device=cuda)

    x1, x2 = batch(n1), batch(n2)
    w1 = torch.tensor(rng.uniform(0.1, 1.0, (n_rep, n1)), dtype=torch.float32,
                      device=cuda)
    ps = qs.PairSpline(t1, t2, mask, cuda)
    tab = ps.table(table)
    gen = torch.Generator(device=cuda).manual_seed(3)

    # K5, two site sets
    (k5,) = _repeatable(lambda: qs.quadspline_fwd(ps, tab, x1, x2))
    assert _rel(k5, qs.quadspline_fwd(ps, tab, x1, x2, plain=True)) < 1e-5
    assert k5.count_nonzero() > 100
    # pairs.pair_coverage dispatches CUDA tensors to the same kernel
    as_dev = (lambda a: torch.as_tensor(a, device=cuda))
    assert torch.equal(k5, pairs.pair_coverage(
        table, as_dev(t1), as_dev(t2), x1, x2, as_dev(mask), ka, k, 1.0))
    g = torch.randn(k5.shape, generator=gen, device=cuda)
    kb = _repeatable(lambda: qs.quadspline_bwd(ps, tab, x1, x2, g))
    for a, b in zip(kb, qs.quadspline_bwd(ps, tab, x1, x2, g, plain=True)):
        assert _rel(a, b) < 1e-4

    # K4
    (k4,) = _repeatable(lambda: qs.colsum_fwd(ps, tab, x1, x2, w1))
    assert _rel(k4, qs.colsum_fwd(ps, tab, x1, x2, w1, plain=True)) < 1e-5
    gc = torch.randn(k4.shape, generator=gen, device=cuda)
    kb = _repeatable(lambda: qs.colsum_bwd(ps, tab, x1, x2, w1, gc))
    for a, b in zip(kb, qs.colsum_bwd(ps, tab, x1, x2, w1, gc, plain=True)):
        assert _rel(a, b) < 1e-4

    # K5 on the rotamer grid shape: one bead set on both sides, and the
    # autograd rule summing both cotangents
    res = np.sort(rng.integers(0, 25, n2))
    tri = (np.arange(n2)[:, None] < np.arange(n2)[None, :]) \
        & (res[:, None] != res[None, :])
    square = table[:, :n_t].contiguous()
    pb = qs.PairSpline(t1[:n2], t1[:n2], tri, cuda)
    gg = g[:, :n2, :n2]
    got = []
    for plain in (False, True):
        x = x2.clone().requires_grad_(True)
        out = qs.quadspline(pb, square, x, x, plain)
        (gx,) = torch.autograd.grad((out * gg).sum(), x)
        got.append((out.detach(), gx))
    assert _rel(got[0][0], got[1][0]) < 1e-5
    assert _rel(got[0][1], got[1][1]) < 1e-4


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", list(bp_cases.PLANES_CASES))
def test_bp_planes_kernel_matches_plain(cuda, case):
    """K6 on a mixed batch, each replica with its own adjacency."""
    E1, E2, adj, res, rot, valid = bp_cases.planes_case(
        **bp_cases.MIXED, **bp_cases.PLANES_CASES[case])
    st = bp.make_statics(res, rot, valid, 128, *bp_cases.BP_SETTINGS, cuda)
    f32 = dict(dtype=torch.float32, device=cuda)
    e1, e2 = torch.tensor(E1, **f32), torch.tensor(E2, **f32)
    a = torch.tensor(adj, device=cuda)
    P = bpp.boltzmann_planes(e2, st.valid)
    iters = _check_bp(
        lambda c, init, tol: bpp.bp_planes_kernel(
            dataclasses.replace(st, tol=tol), c * e1, P, a, init),
        lambda c, init, tol: bpp.bp_bethe_planes_fwd(
            dataclasses.replace(st, tol=tol), c * e1, P, a, init,
            plain=True),
        lambda: a, bp_cases.CASE_LAYOUT.get(case, 0))
    assert len(set(iters)) > 1
    k = bpp.bp_bethe_planes_fwd(st, e1, P, a)
    assert k[2].count_nonzero() > 0 and not k[2][2].any()


@pytest.mark.requires_cuda
def test_bp_planes_kernel_symmetrises_adjacency(cuda):
    """An adjacency given on one side of the diagonal only joins the same
    residues as the symmetric one: K6 returns the same bits for both, and
    its compact list is that of the symmetric adjacency."""
    E1, E2, adj, res, rot, valid = bp_cases.planes_case(
        **bp_cases.MIXED, **bp_cases.PLANES_CASES["40 residues"])
    st = bp.make_statics(res, rot, valid, 128, *bp_cases.BP_SETTINGS, cuda)
    f32 = dict(dtype=torch.float32, device=cuda)
    e1, e2 = torch.tensor(E1, **f32), torch.tensor(E2, **f32)
    a = torch.tensor(adj, device=cuda)
    one_sided = a.clone()
    one_sided[0] = torch.triu(a[0])
    one_sided[1] = torch.tril(a[1])
    assert not torch.equal(one_sided, a)
    P = bpp.boltzmann_planes(e2, st.valid)
    k, sc = bpp.bp_planes_kernel(st, e1, P, one_sided)
    want, sc_w = bpp.bp_planes_kernel(st, e1, P, a)
    assert all(torch.equal(x, y) for x, y in zip(k, want))
    cnt, edges, rev, _ = bp.compact_edges(a)
    assert sc.counts[:, 0].tolist() == cnt.tolist()
    for r, n in enumerate(cnt.tolist()):
        assert torch.equal(sc.edges[r, :n], edges[r, :n])
        assert torch.equal(sc.reverse[r, :n], rev[r, :n])
    p = bpp.bp_bethe_planes_fwd(st, e1, P, one_sided, plain=True)
    assert k[6].tolist() == p[6].tolist()
    for i in range(5):
        assert _rel(k[i], p[i]) < 1e-4


# the row-tile kernels with the per-replica cull (K3, K4, K5's backward):
# layouts that cull every tile, none, tiles that differ between replicas,
# and pairs at the cutoff on tile corners
CULL_STEPS = {"none_culled": [0.02] * 3, "all_culled": [40.0] * 3,
              "mixed": [0.02, 3.8, 20.0]}


def _k3_layout(layout, env_band, device):
    if layout == "at_cutoff":
        prep, x = fused_case(11, env_band, 3.8, device, n_rep=4)
        x1, w1, x2, wcol = (t.clone() for t in x)
        u = np.array([1.0, 0.6, 0.3]) / np.linalg.norm([1.0, 0.6, 0.3])
        p = np.array([2.0, -1.0, 4.0])
        cut_p = prep.kcut_pair / prep.inv_dx
        cut_c = prep.kcut_cov / prep.inv_dx
        for r, (i, j, cut, off) in enumerate(
                ((prep.r_p + 18, 31, cut_p, -1e-5), (prep.r_p + 19, 32, cut_p,
                                                     1e-5),
                 (31, 32, cut_c, -1e-5), (32, 69, cut_c, 1e-5))):
            a, b = corner_layout(prep.n1, prep.n2, i, j, p,
                                 p + (cut + off) * u, device, seed=r)
            x1[r, :, :3], x2[r, :, :3] = a[0, :, :3], b[0, :, :3]
        return prep, (x1, w1, x2, wcol)
    prep, (x1, w1, x2, wcol) = fused_case(12, env_band, None, device,
                                          steps=CULL_STEPS[layout])
    if layout == "all_culled":                  # rows far from the beads
        x1 = x1.clone()
        x1[:, :prep.r_p, :3] += 1000.0
    return prep, (x1.contiguous(), w1, x2, wcol)


def _check_rows(got, want, tol=1e-4):
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert _rel(a, b) < tol


@pytest.mark.requires_cuda
@pytest.mark.parametrize("layout", ["none_culled", "all_culled", "mixed",
                                    "at_cutoff"])
@pytest.mark.parametrize("env_band", [True, False])
def test_k3_cull_layouts(cuda, layout, env_band):
    """K3 against its plain version (rel 1e-4), bitwise repeatable, its
    cull decisions equal to `cull_tiles`, its written flags exactly the
    kept tiles with a live pair, and unmoved by NaN/Inf in the grid
    cotangent's dead and culled slots."""
    from upside_md_torch.ops import tile_cull as tc
    prep, x = _k3_layout(layout, env_band, cuda)
    B = x[0].shape[0]
    fwd = fp.fused_pair_fwd(prep, *x, plain=True, want_planes=False)
    gen = torch.Generator(device=cuda).manual_seed(4)
    g = [torch.randn(t.shape, generator=gen, device=cuda) for t in fwd[:3]]
    flags = torch.full((B, tc.n_tiles(prep.n1), tc.n_tiles(prep.n2)), 7,
                       dtype=torch.uint8, device=cuda)
    bk = fp.fused_pair_bwd_recompute(prep, *x, *g, flags=flags)
    assert all(torch.equal(a, b) for a, b in zip(
        bk, fp.fused_pair_bwd_recompute(prep, *x, *g)))
    _check_rows(bk, fp.fused_pair_bwd_recompute(prep, *x, *g, plain=True))
    keep = fp.cull_tiles(prep, x[0], x[2])
    assert torch.equal((flags & tc.KEPT) != 0, keep)
    # written: kept, and a pair passed the candidate test (every tile with
    # a live pair or a masked-in env pair, and maybe some within the margin)
    live = fused_live(prep, x[0], x[2])
    n_rt, n_ct = keep.shape[1:]
    pad = torch.zeros((B, n_rt * 32, n_ct * 32), dtype=torch.bool,
                      device=cuda)
    pad[:, :prep.n1, :prep.n2] = live
    pad[:, prep.r_e:prep.r_p, :prep.n2] |= prep.mask[prep.r_e:prep.r_p].bool()
    must = pad.reshape(B, n_rt, 32, n_ct, 32).any(4).any(2) & keep
    written = (flags & tc.WRITTEN) != 0
    assert not (must & ~written).any() and not (written & ~keep).any()
    env_tiles = torch.isinf(prep.tile_thresholds)
    if layout == "none_culled":
        assert keep.all()
    elif layout == "all_culled":
        assert not keep[:, :prep.r_e // 32].any()
        assert not keep[:, ~env_tiles].all()
        if not env_band:
            assert not live[:, :prep.r_p].any()
    elif layout == "mixed":
        assert keep[0].all() and not keep[2].all()
    # NaN/Inf in every dead or culled slot of the grid cotangent
    gg = g[1].clone()
    gg[:, prep.n2:] = float("nan")
    gg[:, :, prep.n2:] = float("inf")
    inner = gg[:, :prep.n2, :prep.n2]
    inner[~live[:, prep.r_p:]] = float("nan")
    dirty = fp.fused_pair_bwd_recompute(prep, *x, g[0], gg, g[2])
    assert all(torch.isfinite(a).all() and torch.equal(a, b)
               for a, b in zip(dirty, bk))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("layout", ["none_culled", "all_culled", "mixed",
                                    "at_cutoff"])
@pytest.mark.parametrize("env_band", [True, False])
def test_k1_kernels_match_plain(cuda, layout, env_band):
    """K1's forward and backward kernels on K3's cull layouts
    (`_k1_against_plain`); the forward's column partials written exactly
    where a coverage pair is live; NaN/Inf in the dead slots of the grid
    cotangent and in coverage cotangents of columns without a live
    coverage pair leave the backward unmoved."""
    from upside_md_torch.ops import tile_cull as tc
    prep, x = _k3_layout(layout, env_band, cuda)
    k, g, bk, flags = _k1_against_plain(prep, x, 8)
    live = fused_live(prep, x[0], x[2])
    B, n_rt, n_ct = flags.shape
    pad = torch.zeros((B, n_rt * 32, n_ct * 32), dtype=torch.bool,
                      device=cuda)
    pad[:, :prep.r_e, :prep.n2] = live[:, :prep.r_e]
    cov_live = pad.reshape(B, n_rt, 32, n_ct, 32).any(4).any(2)
    assert torch.equal((flags & tc.WRITTEN) != 0, cov_live)
    if layout == "all_culled":
        assert not k[3].counts[:, :prep.r_e // 32].any()
    g_cov, g_grid = g[0].clone(), g[1].clone()
    g_grid[:, prep.n2:] = float("nan")
    g_grid[:, :, prep.n2:] = float("inf")
    inner = g_grid[:, :prep.n2, :prep.n2]
    inner[~live[:, prep.r_p:]] = float("nan")
    for band, (lo, hi) in enumerate(((0, prep.r_b), (prep.r_b, prep.r_e))):
        dead = ~live[:, lo:hi].any(1)
        g_cov[:, band][dead] = float("nan")
    dirty = fp.fused_pair_bwd(prep, *x, k[3], g_cov, g_grid, g[2])
    assert all(torch.isfinite(a).all() and torch.equal(a, b)
               for a, b in zip(dirty, bk))


# the at_cutoff layouts: replica r holds pair (i, j) at the cutoff + off
# on the facing corners of its tiles
K4_CORNERS = ((31, 32, -1e-5), (32, 31, 1e-5), (99, 134, -1e-5),
              (0, 128, 1e-5))
K5_CORNERS = ((31, 32, -1e-5), (0, 44, 1e-5), (40, 134, -1e-5),
              (63, 64, 1e-5))


def _k4_layout(layout, device):
    if layout == "at_cutoff":
        ps, tab, x1, x2, w1 = spline_case(13, n_rep=4, device=device)
        x1, x2 = x1.clone(), x2.clone()
        u = np.array([0.2, 1.0, 0.5]) / np.linalg.norm([0.2, 1.0, 0.5])
        p = np.array([-3.0, 1.0, 2.0])
        cut = tab.kcut / tab.inv_dx
        for r, (i, j, off) in enumerate(K4_CORNERS):
            a, b = corner_layout(ps.n1, ps.n2, i, j, p, p + (cut + off) * u,
                                 device, seed=r)
            x1[r, :, :3], x2[r, :, :3] = a[0, :, :3], b[0, :, :3]
        return ps, tab, x1, x2, w1
    ps, tab, x1, x2, w1 = spline_case(14, device=device,
                                      steps=CULL_STEPS[layout])
    if layout == "all_culled":
        x1 = x1.clone()
        x1[..., :3] += 1000.0
    return ps, tab, x1, x2, w1


def _k5_layout(layout, device):
    """K5's operands (ps, tab, x1, x2) on the rotamer grid's shape; x1 is
    x2 (one bead set) but where every tile is to be culled."""
    if layout == "at_cutoff":
        ps, tab, x = rotamer_case(13, n_rep=4, device=device)
        x = x.clone()
        u = np.array([0.7, 0.2, 1.0]) / np.linalg.norm([0.7, 0.2, 1.0])
        p = np.array([1.0, -2.0, 3.0])
        cut = tab.kcut / tab.inv_dx
        for r, (i, j, off) in enumerate(K5_CORNERS):
            assert ps.mask[i, j]
            x[r, :, :3] = corner_layout_one(ps.n1, i, j, p,
                                            p + (cut + off) * u, device,
                                            seed=r)[0, :, :3]
        return ps, tab, x, x
    ps, tab, x = rotamer_case(14, device=device, steps=CULL_STEPS[layout])
    if layout == "all_culled":              # rows far from the columns
        x1 = x.clone()
        x1[..., :3] += 1000.0
        return ps, tab, x1, x
    return ps, tab, x, x


@pytest.mark.requires_cuda
@pytest.mark.parametrize("layout", ["none_culled", "all_culled", "mixed",
                                    "at_cutoff"])
@pytest.mark.parametrize("kernel", ["k4_bwd", "k4_fwd", "k5_bwd",
                                    "k5_fwd"])
def test_k4_bwd_cull_layouts(cuda, kernel, layout):
    """K4's and K5's backward and forward against their plain versions
    (rel 1e-4, the forwards 1e-5), bitwise repeatable, their cull
    decisions equal to `cull_tiles` (with the static mask's empty tiles),
    and unmoved by NaN/Inf where no live pair reads them: K4's column
    cotangent and row weights, K5's grid cotangent.  K5's forward marks
    written exactly the kept tiles that hold a live pair."""
    from upside_md_torch.ops import tile_cull as tc
    if kernel in ("k5_bwd", "k5_fwd"):
        ps, tab, x1, x2 = _k5_layout(layout, cuda)
        w1 = None
    else:
        ps, tab, x1, x2, w1 = _k4_layout(layout, cuda)
    ps.tile_alive[1, 2] = 0               # a tile the static mask empties
    ps.mask[32:64, 64:96] = 0
    ps.mask_words = tc.mask_words(ps.mask.cpu().numpy()).to(cuda)
    B = x1.shape[0]
    gen = torch.Generator(device=cuda).manual_seed(5)
    live = qs.live_pairs(ps, tab, x1, x2)
    if kernel == "k4_bwd":
        g = torch.randn((B, ps.n2), generator=gen, device=cuda)
        tol = 1e-4

        def run(g, w1, **kw):
            return qs.colsum_bwd(ps, tab, x1, x2, w1, g, **kw)
    elif kernel == "k4_fwd":
        g, tol = None, 1e-5

        def run(g, w1, **kw):
            return (qs.colsum_fwd(ps, tab, x1, x2, w1, **kw),)
    elif kernel == "k5_fwd":
        g, tol = None, 1e-5

        def run(g, w1, **kw):
            return (qs.quadspline_fwd(ps, tab, x1, x2, **kw),)
    else:
        g = torch.randn((B, ps.n1, ps.n2), generator=gen, device=cuda)
        tol = 1e-4

        def run(g, w1, **kw):
            return qs.quadspline_bwd(ps, tab, x1, x2, g, **kw)
    flags = torch.full((B,) + tuple(ps.tile_alive.shape), 7,
                       dtype=torch.uint8, device=cuda)
    bk = run(g, w1, flags=flags)
    assert all(torch.equal(a, b) for a, b in zip(bk, run(g, w1)))
    _check_rows(bk, run(g, w1, plain=True), tol)
    keep = qs.cull_tiles(ps, tab, x1, x2)
    assert torch.equal((flags & tc.KEPT) != 0, keep)
    assert not keep[:, 1, 2].any()
    if layout == "none_culled":
        assert keep.sum() == B * ps.tile_alive.sum()
    elif layout == "all_culled":
        assert not keep.any() and not live.any()
        assert all(not a.any() for a in bk)
    elif layout == "mixed":
        assert not torch.equal(keep[0], keep[2])
    if kernel == "k5_fwd":
        n_rt, n_ct = keep.shape[1:]
        held = torch.zeros((B, n_rt * 32, n_ct * 32), dtype=torch.bool,
                           device=cuda)
        held[:, :ps.n1, :ps.n2] = live
        held = held.reshape(B, n_rt, 32, n_ct, 32).any(4).any(2)
        assert torch.equal((flags & tc.WRITTEN) != 0, held)
        assert torch.equal(bk[0] != 0, live)
        return
    if kernel == "k5_bwd":
        gd = g.clone()
        gd[~live] = float("nan")
        wd = None
    else:
        wd = w1.clone()
        wd[~live.any(2)] = float("inf")
        gd = None if g is None else g.clone()
        if gd is not None:
            gd[~live.any(1)] = float("nan")
    dirty = run(gd, wd)
    assert all(torch.isfinite(a).all() and torch.equal(a, b)
               for a, b in zip(dirty, bk))


@pytest.mark.requires_cuda
def test_row_tile_kernels_with_a_warp_per_row_tile(cuda):
    """With enough replicas that the row tiles alone fill the card, K1's
    forward and backward, K3, K4's and K5's forward and backward give each
    row tile one warp (four below that): against their plain versions (K1
    and K5 on the first four replicas), bitwise repeatable."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    prep, x = fused_case(15, True, 3.8, cuda, n_rep=1)
    n_rep = -(-sms * 32 // -(-prep.n1 // 32)) + 1
    x = tuple(t.repeat(n_rep, *([1] * (t.dim() - 1))) for t in x)
    x1 = x[0].clone()
    x1[..., :3] += 0.2 * torch.randn(x1[..., :3].shape, device=cuda,
                                     generator=torch.Generator(
                                         device=cuda).manual_seed(6))
    x = (x1, x[1], x1[:, prep.r_p:].contiguous(), x[3])
    fwd = fp.fused_pair_fwd(prep, *x, plain=True, want_planes=False)
    gen = torch.Generator(device=cuda).manual_seed(7)
    g = [torch.randn(t.shape, generator=gen, device=cuda) for t in fwd[:3]]
    bk = fp.fused_pair_bwd_recompute(prep, *x, *g)
    assert all(torch.equal(a, b) for a, b in zip(
        bk, fp.fused_pair_bwd_recompute(prep, *x, *g)))
    _check_rows(bk, fp.fused_pair_bwd_recompute(prep, *x, *g, plain=True))
    # K1's forward and backward, checked on the first four replicas
    _k1_against_plain(prep, x, 9, first=slice(0, 4))

    ps, tab, x1, x2, w1 = spline_case(16, n_rep=1, device=cuda)
    n_rep = -(-sms * 32 // -(-ps.n1 // 32)) + 1
    x1, x2, w1 = (t.repeat(n_rep, *([1] * (t.dim() - 1)))
                  for t in (x1, x2, w1))
    x1 = x1 + 0.2 * torch.randn(x1.shape, device=cuda, generator=gen) \
        * torch.tensor([1.0, 1, 1, 0, 0, 0], device=cuda)
    gc = torch.randn((n_rep, ps.n2), generator=gen, device=cuda)
    kb = qs.colsum_bwd(ps, tab, x1, x2, w1, gc)
    assert all(torch.equal(a, b) for a, b in zip(
        kb, qs.colsum_bwd(ps, tab, x1, x2, w1, gc)))
    _check_rows(kb, qs.colsum_bwd(ps, tab, x1, x2, w1, gc, plain=True))
    k4 = qs.colsum_fwd(ps, tab, x1, x2, w1)
    assert torch.equal(k4, qs.colsum_fwd(ps, tab, x1, x2, w1))
    _check_rows((k4,), (qs.colsum_fwd(ps, tab, x1, x2, w1, plain=True),),
                1e-5)

    # K5's backward on the rotamer grid's shape, the first four replicas
    # against the plain version
    ps, tab, x = rotamer_case(17, n_rep=1, device=cuda)
    n_rep = -(-sms * 32 // -(-ps.n1 // 32)) + 1
    x = x.repeat(n_rep, 1, 1)
    x = x + 0.2 * torch.randn(x.shape, device=cuda, generator=gen) \
        * torch.tensor([1.0, 1, 1, 0, 0, 0], device=cuda)
    g = torch.randn((n_rep, ps.n1, ps.n2), generator=gen, device=cuda)
    kb = qs.quadspline_bwd(ps, tab, x, x, g)
    assert all(torch.equal(a, b) for a, b in zip(
        kb, qs.quadspline_bwd(ps, tab, x, x, g)))
    first = slice(0, 4)
    _check_rows([t[first] for t in kb], qs.quadspline_bwd(
        ps, tab, x[first], x[first], g[first], plain=True))
    # and K5's forward
    k5 = qs.quadspline_fwd(ps, tab, x, x)
    assert torch.equal(k5, qs.quadspline_fwd(ps, tab, x, x))
    _check_rows((k5[first],), (qs.quadspline_fwd(ps, tab, x[first], x[first],
                                                 plain=True),), 1e-5)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", ["rotamer", "two_sets"])
def test_k5_fwd_writes_every_element(cuda, shape):
    """K5's forward launched into a grid filled with NaN overwrites every
    element: exact zeros where the plain grid is 0 (no live pair), values
    rel 1e-5 elsewhere; on the rotamer call (one bead set on both sides,
    the triangular mask across residues) and on two site sets with a
    random mask, in two layouts each, one that the cull thins."""
    from upside_md_torch.ops import kernels
    from upside_md_torch.ops import tile_cull as tc
    for step in (3.8, 12.0):
        if shape == "rotamer":
            ps, tab, x = rotamer_case(18, device=cuda, step=step)
            x1 = x2 = x
        else:
            ps, tab, x1, x2, _ = spline_case(19, device=cuda, step=step)
        B = x1.shape[0]
        out = torch.full((B, ps.n1, ps.n2), float("nan"), device=cuda)
        flags = torch.full((B,) + tuple(ps.tile_alive.shape), 7,
                           dtype=torch.uint8, device=cuda)
        kernels.launch("quadspline_fwd", x1, x2, ps.t1, ps.t2,
                       ps.mask_words, ps.tile_alive, tab.coef, B, ps.n1,
                       ps.n2, tab.ka, tab.k, tab.n_t2, tab.ncoef, tab.inv_dx,
                       tab.kcut, tc.cutoff_sq(tab.kcut, tab.inv_dx), flags,
                       out)
        torch.cuda.synchronize()
        want = qs.quadspline_fwd(ps, tab, x1, x2, plain=True)
        assert torch.isfinite(out).all()
        assert torch.equal(out == 0, want == 0)
        assert (want != 0).sum() > 50
        assert _rel(out, want) < 1e-5
        keep = qs.cull_tiles(ps, tab, x1, x2)
        assert torch.equal((flags & tc.KEPT) != 0, keep)
        if step > 10.0:
            assert not keep[:, ps.tile_alive.bool()].all()


@pytest.mark.requires_cuda
def test_stacked_table_launch_per_slot_matches_batched(cuda):
    """The trp-cage system with its rotamer table stacked over 4 identical
    slots: the fused block runs once a slot with its own operands (4 K1
    launches each way, K2 still once), and energies, forces and BP
    beliefs equal the shared table's one batched launch bit for bit."""
    from upside_md_torch.ops import kernels
    from upside_md_torch.system import System
    system, pos = System.from_bundle(
        os.path.join(DATA_DIR, "trp_cage_full_synth.npz"), device=cuda)
    n = 4
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = pos + 0.05 * torch.randn((n,) + tuple(pos.shape), generator=gen,
                                 device=cuda)
    params = {k: dict(v) for k, v in system.params.items()}
    table = system.params["rotamer"]["interaction_param"]
    params["rotamer"]["interaction_param"] = table.expand(
        (n,) + tuple(table.shape)).clone()
    assert len(system.fused_prepared(params)) == n
    kernels.reset_counts()
    g, e, c = system.deriv(x, None, None, params)
    per_slot = dict(kernels.LAUNCHES)
    kernels.reset_counts()
    g0, e0, c0 = system.deriv(x)
    batched = dict(kernels.LAUNCHES)
    assert per_slot["fused_pair_fwd"] == per_slot["fused_pair_bwd"] == n
    assert batched["fused_pair_fwd"] == batched["fused_pair_bwd"] == 1
    assert per_slot["bp_bethe_pairs"] == batched["bp_bethe_pairs"] == 1
    assert torch.equal(e, e0) and torch.equal(g, g0)
    assert torch.equal(c["rotamer"]["nb"], c0["rotamer"]["nb"])


@pytest.mark.requires_cuda
def test_cold_k2_after_warm_matches_plain(cuda):
    """K2 cold, warm from that solution, then cold again: the second cold
    call equals the first bit for bit (no warm state left behind), takes
    the plain cold solve's sweep counts and matches its values rel
    1e-4."""
    E1, E, res, rot, valid, n2p = bp_cases.pairs_case(3, **bp_cases.MIXED)
    st = bp.make_statics(res, rot, valid, n2p, *bp_cases.BP_SETTINGS, cuda)
    f32 = dict(dtype=torch.float32, device=cuda)
    e1, ep = torch.tensor(E1, **f32), torch.tensor(E, **f32)
    cold = bp.bp_bethe_pairs_fwd(st, e1, ep)
    warm = bp.bp_bethe_pairs_fwd(st, e1, ep, (cold[3], cold[4]))
    assert (warm[6] <= cold[6]).all() and (warm[6] < cold[6]).any()
    again = bp.bp_bethe_pairs_fwd(st, e1, ep)
    assert all(torch.equal(a, b) for a, b in zip(cold, again))
    plain = bp.bp_bethe_pairs_fwd(st, e1, ep, plain=True)
    assert cold[6].tolist() == plain[6].tolist()
    for i in range(5):
        assert _rel(cold[i], plain[i]) < 1e-4, i


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name, launched", [
    ("t4_lysozyme_full_synth",
     {"quadspline_fwd", "quadspline_bwd", "colsum_fwd", "colsum_bwd"}),
    ("gfp_full_synth",
     {"gather_rows_bwd", "nlist_spline_fwd", "nlist_spline_bwd"})])
def test_large_systems_on_the_card_match_the_host(cuda, name, launched):
    """T4 lysozyme (164 residues, 770 beads) and GFP (238 residues, 1,143
    beads) evaluate on the card: past 128 residues BP is the plain port of
    `_bp_solve`, so K6 does not launch; T4 lysozyme's grid and coverages
    are K5 and K4, GFP's are neighbour lists, so GFP launches the lists'
    pair spline (`nlist_spline_fwd`, `nlist_spline_bwd`) and the fixed-order
    sums of their column cotangents (`gather_rows_bwd`).
    Energy and forces of two replicas in float32 against the port on the
    CPU in float64, both at BP tol 1e-6: rel 1e-3, forces as RMS relative
    error."""
    from upside_md_torch.config import bundle
    from upside_md_torch.ops import kernels
    from upside_md_torch.system import System
    specs, pos = bundle.load(os.path.join(DATA_DIR, name + ".npz"))
    for s in specs:
        if s.type_name == "rotamer":
            s.consts["tol"] = 1e-6
    x = np.stack([pos, pos]) + 0.05 * np.random.default_rng(4).normal(
        size=(2,) + pos.shape)
    card = System(len(pos), specs, cuda)
    host = System(len(pos), specs, "cpu", torch.float64)
    kernels.reset_counts()
    g, e, _ = card.deriv(torch.tensor(x, dtype=torch.float32, device=cuda))
    assert {k for k, v in kernels.LAUNCHES.items() if v} == launched
    g_h, e_h, _ = host.deriv(torch.tensor(x))
    assert _rel(e, e_h) < 1e-3
    g = g.double().cpu()
    assert ((g - g_h).pow(2).mean().sqrt()
            / g_h.pow(2).mean().sqrt()).item() < 1e-3


# the tables of the five spline families of `pairs.quadspline_family`, by
# their entry count M = 2 ka + 2 k
COTANGENT_FAMILIES = (34, 30, 62, 54, 40)


def cotangent_case(seed, M, n1=71, n2=135, n_rep=3, device=None,
                   one_set=False):
    """`fp.table_cotangent`'s operands (table, t1, t2, x1, x2, mask, g)
    for a table of M entries: rows and columns along one random walk of
    3.8 dx steps a replica, so that many pairs are live and some lie
    within dx (the clamped end's stencil); n1 = 71 and n2 = 135 cut the
    kernel's blocks of 2 rows and 32 columns raggedly.  `one_set`: the
    rotamer grid's shape, one bead set of n2 both sides, the mask
    upper-triangular across residues of two beads."""
    _, _, dx = pairs.quadspline_family(M)
    rng = np.random.default_rng(seed)
    n_t = 5
    table = _f32(0.5 * rng.normal(size=(3 if not one_set else n_t, n_t, M)),
                 device)
    t2 = rng.integers(0, n_t, n2)
    if one_set:
        n1, t1 = n2, t2
        mask = rotamer_mask(np.arange(n2) // 2)
    else:
        t1 = rng.integers(0, 3, n1)
        mask = rng.random((n1, n2)) > 0.2
    x1, x2 = [], []
    for _ in range(n_rep):
        path = walk(rng, n2, 3.8 * dx)
        x2.append(chain_sites(rng, path, n2, 1))
        x1.append(x2[-1] if one_set else chain_sites(rng, path, n1, 1))
    x1, x2 = _f32(np.concatenate(x1), device), _f32(np.concatenate(x2),
                                                    device)
    return (table, torch.tensor(t1, device=device),
            torch.tensor(t2, device=device), x1, x1 if one_set else x2,
            torch.tensor(mask, device=device),
            _f32(rng.normal(size=(n_rep, n1, n2)), device))


def cotangent_live(args):
    """(B, n1, n2) the pairs `table_cotangent` takes: mask and s = dist /
    dx below the family's cutoff."""
    table, _, _, x1, x2, mask, _ = args
    _, k, dx = pairs.quadspline_family(table.shape[-1])
    with torch.no_grad():
        dist = fp._geometry(x1, x2)[1]
    return mask.bool() & (dist * (1.0 / dx) < k - 2 - 1e-6)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("M", COTANGENT_FAMILIES)
@pytest.mark.parametrize("n_rep", [1, 37])
def test_table_cotangent_matches_plain(cuda, M, n_rep):
    """`table_cotangent`'s kernel against its plain version in each
    family at rel 1e-4 (max-normalised), one launch a call, bitwise equal
    on a second call; 1 replica and 37."""
    from upside_md_torch.ops import kernels
    args = cotangent_case(20 + M, M, n_rep=n_rep, device=cuda)
    assert cotangent_live(args).sum() > 50
    before = kernels.LAUNCHES["table_cotangent"]
    got = _repeatable(lambda: fp.table_cotangent(*args))[0]
    assert kernels.LAUNCHES["table_cotangent"] == before + 2
    want = fp.table_cotangent(*args, plain=True)
    assert got.shape == want.shape == args[0].shape
    assert _rel(got, want) < 1e-4


@pytest.mark.requires_cuda
@pytest.mark.parametrize("M", COTANGENT_FAMILIES)
def test_table_cotangent_at_the_cutoff(cuda, M):
    """Each replica holds one masked row-column pair at the family's
    cutoff + 1e-5 A or - 1e-5 A (every other pair 1,000 A apart): the
    kernel takes the pairs inside and leaves those outside, as the plain
    version does: rel 1e-4, and the pairs outside add nothing (their
    replicas' cotangents zeroed: bitwise the same)."""
    _, k, dx = pairs.quadspline_family(M)
    table, t1, t2, _, _, mask, g = cotangent_case(30 + M, M, n_rep=4,
                                                  device=cuda)
    n1, n2 = mask.shape
    rng = np.random.default_rng(M)
    x1, x2 = np.zeros((4, n1, 6)), np.zeros((4, n2, 6))
    for x in (x1, x2):
        d = rng.normal(size=x[..., 3:].shape)
        x[..., 3:] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    x1[..., 0] = 1000.0 * (1 + np.arange(n1))
    x2[..., 0] = -1000.0 * (1 + np.arange(n2))
    u = np.array([0.3, -0.5, 1.0]) / np.linalg.norm([0.3, -0.5, 1.0])
    p = np.array([2.0, -1.0, 0.5])
    cut = (k - 2 - 1e-6) * dx
    inside = [False, True, False, True]
    live = np.argwhere(mask.cpu().numpy())
    for r, (i, j) in enumerate(live[rng.choice(len(live), 4, False)]):
        x1[r, i, :3] = p
        x2[r, j, :3] = p + (cut + (-1e-5 if inside[r] else 1e-5)) * u
    x1, x2 = _f32(x1, cuda), _f32(x2, cuda)
    args = (table, t1, t2, x1, x2, mask, g)
    taken = cotangent_live(args).any(-1).any(-1).cpu().tolist()
    assert taken == inside
    got = fp.table_cotangent(*args)
    assert got.abs().max() > 0
    assert _rel(got, fp.table_cotangent(*args, plain=True)) < 1e-4
    g_in = g * torch.tensor(inside, device=cuda)[:, None, None]
    assert torch.equal(got, fp.table_cotangent(*args[:-1], g_in))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("M", COTANGENT_FAMILIES)
def test_table_cotangent_nan_in_dead_slots(cuda, M):
    """NaN and Inf in g where the mask or the cutoff leaves a pair dead
    leave the kernel's result unmoved, bit for bit."""
    args = cotangent_case(40 + M, M, n_rep=5, device=cuda)
    live = cotangent_live(args)
    masked = args[5].bool()[None].expand_as(live)
    assert live.any() and (masked & ~live).any() and (~masked).any()
    g = args[-1]
    bad = torch.where(torch.rand(g.shape, device=cuda) < 0.5,
                      torch.full_like(g, math.nan),
                      torch.full_like(g, math.inf))
    poisoned = torch.where(live, g, bad)
    clean = fp.table_cotangent(*args)
    assert torch.isfinite(clean).all()
    assert torch.equal(fp.table_cotangent(*args[:-1], poisoned), clean)


@pytest.mark.requires_cuda
def test_table_cotangent_reads_a_strided_grid(cuda):
    """The pair band's operand as the fused block passes it, g_grid[:,
    :n2, :n2] of a padded (B, n2p, n2p) grid, on the rotamer grid's shape
    (one bead set both sides): bitwise equal to the kernel on its
    contiguous copy, and to the plain version at rel 1e-4."""
    table, t1, t2, x1, x2, mask, _ = cotangent_case(50, 34, n_rep=6,
                                                    device=cuda, one_set=True)
    n = x1.shape[1]
    grid = torch.randn((6, 160, 160), device=cuda)
    view = grid[:, :n, :n]
    assert not view.is_contiguous()
    args = (table, t1, t2, x1, x2, mask)
    got = fp.table_cotangent(*args, view)
    assert torch.equal(got, fp.table_cotangent(*args, view.contiguous()))
    assert _rel(got, fp.table_cotangent(*args, view, plain=True)) < 1e-4


@pytest.mark.requires_cuda
def test_block_table_cotangents_launch_per_band(cuda):
    """`fp.block_table_cotangents` of the fused block's three spline
    bands (the coverage bands' w1 g_cov products, the pair band's strided
    grid): one launch a band, each against `plain=True` at rel 1e-4; a
    float64 call on the card raises without `plain`."""
    from upside_md_torch.ops import kernels
    prep, (x1, w1, x2, wcol) = fused_case(3, True, 3.8, cuda)
    tabs = [_f32(t, cuda) for t in fused_problem(np.random.default_rng(3))[0]]
    B = x1.shape[0]
    g_cov = torch.randn((B, 2, prep.n2), device=cuda)
    g_grid = torch.randn((B, prep.n2p, prep.n2p), device=cuda)
    g_env = torch.randn((B, prep.n_e), device=cuda)
    args = (prep, (True, True, True, False), tabs + [None], x1, w1, x2,
            wcol, g_cov, g_grid, g_env)
    before = kernels.LAUNCHES["table_cotangent"]
    got = fp.block_table_cotangents(*args)
    assert kernels.LAUNCHES["table_cotangent"] == before + 3
    want = fp.block_table_cotangents(*args, plain=True)
    assert kernels.LAUNCHES["table_cotangent"] == before + 3
    assert got[3] is None and want[3] is None
    for a, b in zip(got[:3], want[:3]):
        assert b.abs().max() > 0
        assert _rel(a, b) < 1e-4
    c = cotangent_case(60, 34, device=cuda)
    c64 = [t.double() if t.is_floating_point() else t for t in c]
    with pytest.raises(ValueError):
        fp.table_cotangent(*c64)
    assert _rel(fp.table_cotangent(*c64, plain=True),
                fp.table_cotangent(*c, plain=True)) < 1e-4


@pytest.mark.requires_cuda
@pytest.mark.parametrize("node", ["rotamer", "hbond_coverage"])
def test_unfused_table_gradient_matches_plain(cuda, node):
    """Past the fused block's caps (T4 lysozyme: K5's rotamer grid, K4's
    coverages) a table's gradient takes `quadspline._table_grad`:
    `System.param_deriv` of two replicas with kernels, which launches
    `table_cotangent` once, against `kernels=False` (no launch) at rel
    1e-3, BP run 100 sweeps with its convergence test off so that both
    take the same schedule."""
    from upside_md_torch.config import bundle
    from upside_md_torch.ops import kernels
    from upside_md_torch.system import System
    specs, pos = bundle.load(os.path.join(DATA_DIR,
                                          "t4_lysozyme_full_synth.npz"))
    for s in specs:
        if s.type_name == "rotamer":
            s.consts["tol"] = -1.0
            s.consts["max_iter"] = 100
    x = np.stack([pos, pos]) + 0.05 * np.random.default_rng(6).normal(
        size=(2,) + pos.shape)
    x = torch.tensor(x, dtype=torch.float32, device=cuda)
    card = System(len(pos), specs, cuda)
    plain = System(len(pos), specs, cuda, kernels=False)
    assert card.pair_fusion is None
    kernels.reset_counts()
    got = card.param_deriv(x, node)["interaction_param"]
    assert kernels.LAUNCHES["table_cotangent"] == 1
    want = plain.param_deriv(x, node)["interaction_param"]
    assert kernels.LAUNCHES["table_cotangent"] == 1
    assert want.abs().max() > 0
    assert _rel(got, want) < 1e-3


def nl_call(args, K, plain=False, table_grad=False, seed=7):
    """`pairs.quadspline_coverage_nl` on `cotangent_case`'s operands with
    a list width K, and its backward under a seeded cotangent: (values,
    idx, mask, the gradients of x1 and x2 (one for one bead set), and the
    table's when `table_grad`)."""
    table, t1, t2, x1, x2, mask, _ = args
    ka, k, dx = pairs.quadspline_family(table.shape[-1])
    ps = qs.PairSpline(t1.cpu().numpy(), t2.cpu().numpy(),
                       mask.cpu().numpy(), x1.device)
    leaves = [x.detach().clone().requires_grad_(True)
              for x in ((x1,) if x2 is x1 else (x1, x2))]
    # one (position, direction) pair for both sides of one bead set
    sides = [(x[..., :3], x[..., 3:6]) for x in leaves]
    rows, cols = sides[0], sides[-1]
    tab = table.detach().clone().requires_grad_(table_grad)
    v, idx, m = pairs.quadspline_coverage_nl(
        tab, t1, t2, *rows, *cols, ka, k, 1.0 / dx, mask.bool(), K,
        plain=plain, spline=ps)
    gen = torch.Generator(device=v.device).manual_seed(seed)
    g = torch.randn(v.shape, generator=gen, device=v.device)
    wrt = leaves + ([tab] if table_grad else [])
    return (v.detach(), idx, m) + torch.autograd.grad((v * g).sum(), wrt)


def _nl_against_plain(args, K, table_grad=True):
    """The kernels' call (twice: bitwise the same, one launch of each
    kernel a call) against `plain=True`: the same partners, values rel
    1e-5, gradients rel 1e-4.  Returns the kernels' results."""
    from upside_md_torch.ops import kernels
    before = [kernels.LAUNCHES[n] for n in ("nlist_spline_fwd",
                                           "nlist_spline_bwd")]
    got = _repeatable(lambda: nl_call(args, K, table_grad=table_grad))
    assert [kernels.LAUNCHES[n] for n in ("nlist_spline_fwd",
                                          "nlist_spline_bwd")] == \
        [b + 2 for b in before]
    want = nl_call(args, K, plain=True, table_grad=table_grad)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert not got[0][~got[2]].any()
    assert got[0].count_nonzero() > 50
    assert _rel(got[0], want[0]) < 1e-5
    for a, b in zip(got[3:], want[3:]):
        assert b.abs().max() > 0
        assert _rel(a, b) < 1e-4
    return got


@pytest.mark.requires_cuda
@pytest.mark.parametrize("M", COTANGENT_FAMILIES)
@pytest.mark.parametrize("n_rep", [1, 37])
def test_nlist_spline_matches_plain(cuda, M, n_rep):
    """Each family at 1 and 37 replicas, at a list width of half the
    largest partner count, which rows overflow (their farthest partners
    dropped, as the plain list drops them), and at one that none does."""
    args = cotangent_case(70 + M, M, n_rep=n_rep, device=cuda)
    _, _, _, x1, x2, mask, _ = args
    _, k, dx = pairs.quadspline_family(M)
    most = int(pairs.partner_counts(x1[..., :3], x2[..., :3],
                                    ((k - 2 - 1e-6) * dx) ** 2,
                                    mask.bool()).max())
    assert most >= 2
    for K in (most // 2, most + 3):
        _nl_against_plain(args, K)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("M", [34, 62])
def test_nlist_spline_one_bead_set(cuda, M):
    """The rotamer grid's shape: one bead set x (B, n, 6) on both sides,
    the mask upper-triangular across residues; autograd sums the rows' and
    the columns' cotangents of x."""
    _nl_against_plain(cotangent_case(80 + M, M, n_rep=4, device=cuda,
                                     one_set=True), 12)


def gfp_lists(device, n_rep=2):
    """GFP's three neighbour lists' operands at perturbed positions, as
    the nodes form them: [(site, (table, t1, t2, x1, x2, mask, None),
    K)]; the rotamer grid's x1 is its x2."""
    from upside_md_torch.nodes import hbond, rotamer
    from upside_md_torch.system import System
    system, pos = System.from_bundle(
        os.path.join(DATA_DIR, "gfp_full_synth.npz"), device=device)
    gen = torch.Generator(device=device).manual_seed(5)
    x = pos + 0.05 * torch.randn((n_rep,) + tuple(pos.shape),
                                 generator=gen, device=device)
    with torch.no_grad():
        outs = system.evaluate(x)[1]
    lists = []
    for s in system.specs:
        c = system.consts[s.name]
        if s.node_type.name == "hbond_coverage":
            x1 = outs[s.args[0]][:, c["index1"], :6].contiguous()
            x2 = outs[s.args[1]][:, c["index2"], :6].contiguous()
            lists.append((s.name, (system.params[s.name]["interaction_param"],
                                   c["type1"], c["type2"], x1, x2,
                                   c["spline"].mask, None),
                          hbond.COVERAGE_NEIGHBOR_K))
        elif s.node_type.name == "rotamer":
            beads = outs[s.args[0]][:, c["index"], :6].contiguous()
            lists.append((s.name, (system.params[s.name]["interaction_param"],
                                   c["type"], c["type"], beads, beads,
                                   c["spline"].mask, None),
                          min(beads.shape[1], rotamer.NEIGHBOR_K)))
    return lists


@pytest.mark.requires_cuda
def test_nlist_spline_on_gfp_lists(cuda):
    """GFP's rotamer grid (1,143 x 1,143, K 128) and coverages (464 and
    714 x 1,143, K 96) against `plain=True`, table gradients included."""
    shapes = []
    for _, args, K in gfp_lists(cuda):
        _nl_against_plain(args, K)
        shapes.append((args[3].shape[1], args[4].shape[1], K))
    assert sorted(shapes) == [(464, 1143, 96), (714, 1143, 96),
                              (1143, 1143, 128)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("M", COTANGENT_FAMILIES)
def test_nlist_spline_nan_in_dead_slots(cuda, M):
    """The kernels' wrappers on a built list: NaN and Inf in the cotangent
    where the mask is off or the pair outside the cutoff, and indices far
    out of range where the mask is off, leave the values, the rows'
    cotangents and the kept slots' column cotangents unmoved, bit for
    bit; dead slots' values are 0 and kept slots past the cutoff carry a
    0 column cotangent."""
    table, t1, t2, x1, x2, mask, _ = cotangent_case(90 + M, M, n_rep=5,
                                                    device=cuda)
    _, k, dx = pairs.quadspline_family(M)
    ps = qs.PairSpline(t1.cpu().numpy(), t2.cpu().numpy(),
                       mask.cpu().numpy(), cuda)
    tab = ps.table(table)
    # a list wider than the cutoff's: kept slots past it too
    idx, kept = pairs.neighbor_list(x1[..., :3], x2[..., :3],
                                    ((k + 2) * dx) ** 2, mask.bool(), 24)
    with torch.no_grad():
        cols = torch.gather(x2[..., :3], 1, idx.reshape(idx.shape[0], -1, 1)
                            .expand(-1, -1, 3)).reshape(idx.shape + (3,))
        dist = (cols - x1[:, :, None, :3]).norm(dim=-1)
    live = kept & (dist * (1.0 / dx) < k - 2 - 1e-6)
    assert live.any() and (kept & ~live).any() and (~kept).any()
    gen = torch.Generator(device=cuda).manual_seed(M)
    g = torch.randn(idx.shape, generator=gen, device=cuda)
    bad = torch.where(torch.rand(g.shape, device=cuda) < 0.5,
                      torch.full_like(g, math.nan),
                      torch.full_like(g, math.inf))
    far = torch.full_like(idx, 1 << 40)
    clean = pairs.nlist_spline_fwd(ps, tab, x1, x2, idx, kept)
    assert not clean[~live].any() and clean[live].count_nonzero() > 0
    d1, dslot = pairs.nlist_spline_bwd(ps, tab, x1, x2, idx, kept, g)
    poisoned_idx = torch.where(kept, idx, far)
    assert torch.equal(pairs.nlist_spline_fwd(ps, tab, x1, x2, poisoned_idx,
                                              kept), clean)
    p1, pslot = pairs.nlist_spline_bwd(ps, tab, x1, x2, poisoned_idx, kept,
                                       torch.where(live, g, bad))
    assert torch.isfinite(d1).all() and torch.equal(p1, d1)
    assert torch.equal(pslot[kept], dslot[kept])
    assert not dslot[kept & ~live].any()


@pytest.mark.requires_cuda
def test_nlist_spline_refuses_float64(cuda):
    """A float64 CUDA call raises: the kernels take float32 and nothing
    falls back; with `plain=True` it runs the plain version."""
    args = cotangent_case(95, 34, device=cuda)
    args64 = [t.double() if t is not None and t.is_floating_point() else t
              for t in args]
    with pytest.raises(ValueError):
        nl_call(args64, 8)
    v64 = nl_call(args64, 8, plain=True)[0]
    assert _rel(v64, nl_call(args, 8, plain=True)[0]) < 1e-5
