"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.

Every test is marked `requires_cuda` and skips where
`torch.cuda.is_available()` is False.  The module imports no JAX, so it
runs on the GPU machine too, without the JAX conftest:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Problems are seeded numpy, float32, several replicas that differ, and span
several 32x32 tiles with ragged edges so the per-tile partial sums are
exercised.  Tolerances: K1, K4 and K5 forward rel 1e-5 and backward (K3
too) rel 1e-4 (f32, two summation orders); K2 and K6 at the BP tol of
`bp_cases` (1e-4), rel 1e-4, sweep counts equal to the plain solve's, the
compact edge list and its indices equal to `compact_edges`, each case in
the layout of the solve its edge count calls for (messages and factors in
shared memory, messages only, global scratch); and again at BP tol 1e-6,
values rel 1e-4 (there float32 rounding of the deviation decides the stop,
so sweep counts are not compared).  Kernels must be bitwise repeatable.
"""

import dataclasses

import numpy as np
import pytest
import torch

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


@pytest.mark.requires_cuda
def test_fused_kernels_match_plain(cuda):
    tabs, t1, t2, masks, env, dyn = fused_problem(np.random.default_rng(0))
    prep = fp.make_prep(tabs, t1, t2, masks, env, cuda, torch.float32)
    x1, w1, x2, wcol = (torch.tensor(a, dtype=torch.float32, device=cuda)
                        for a in dyn)
    k = fp.fused_pair_fwd(prep, x1, w1, x2, wcol)
    p = fp.fused_pair_fwd(prep, x1, w1, x2, wcol, plain=True)
    assert all(torch.equal(a, b) for a, b in
               zip(k, fp.fused_pair_fwd(prep, x1, w1, x2, wcol)))
    for a, b in zip(k, p):
        assert _rel(a, b) < 1e-5
    assert k[1].count_nonzero() > 10 and k[2].count_nonzero() > 3
    gen = torch.Generator(device=cuda).manual_seed(1)
    g = [torch.randn(t.shape, generator=gen, device=cuda) for t in p[:3]]
    bk = fp.fused_pair_bwd(prep, x1, w1, x2, wcol, k[3], k[4], *g)
    bp_ = fp.fused_pair_bwd(prep, x1, w1, x2, wcol, p[3], p[4], *g,
                            plain=True)
    for a, b in zip(bk, bp_):
        assert _rel(a, b) < 1e-4


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
    assert k[3] is None and k[4] is None
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
