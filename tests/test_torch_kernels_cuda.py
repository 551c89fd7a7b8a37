"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.

Every test is marked `requires_cuda` and skips where
`torch.cuda.is_available()` is False.  The module imports no JAX, so it
runs on the GPU machine too, without the JAX conftest:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Problems are seeded numpy, float32, several replicas that differ, and span
several 32x32 tiles with ragged edges so the per-tile partial sums are
exercised.  Tolerances: K1, K4 and K5 forward rel 1e-5 and backward (K3
too) rel 1e-4 (f32, two summation orders); K2 and K6 at BP tol 1e-6, rel
1e-4.  Kernels must be bitwise repeatable.
"""

import numpy as np
import pytest
import torch

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


def bp_problem(rng, n_res=12, contact=0.35):
    n_rot = rng.choice([1, 3, 6], size=n_res)
    res = np.repeat(np.arange(n_res), n_rot)
    rot = np.concatenate([np.arange(n) for n in n_rot])
    valid = np.arange(6)[None, :] < n_rot[:, None]
    n = len(res)
    near = rng.random((n_res, n_res)) < contact
    keep = (np.arange(n)[:, None] < np.arange(n)[None, :]) \
        & (res[:, None] != res[None, :]) \
        & (near | near.T)[res[:, None], res[None, :]]
    E = np.zeros((128, 128))
    E[:n, :n] = np.where(keep, rng.normal(scale=1.5, size=(n, n)), 0.0)
    E1 = np.where(valid, rng.normal(size=(n_res, 6)), 0.0)
    return E1, E, res, rot, valid


@pytest.mark.requires_cuda
def test_bp_kernel_matches_plain(cuda):
    E1, E, res, rot, valid = bp_problem(np.random.default_rng(0))
    st = bp.make_statics(res, rot, valid, 128, 0.1, 1000, 1e-6, 2, cuda)
    e1 = torch.tensor(np.stack([E1, 0.9 * E1, E1 + 0.1]), dtype=torch.float32,
                      device=cuda)
    ep = torch.tensor(np.stack([E] * 3), dtype=torch.float32, device=cuda)
    k = bp.bp_bethe_pairs_fwd(st, e1, ep)
    p = bp.bp_bethe_pairs_fwd(st, e1, ep, plain=True)
    assert all(torch.equal(a, b) for a, b in
               zip(k, bp.bp_bethe_pairs_fwd(st, e1, ep)))
    for i in (0, 1, 2, 3):
        assert _rel(k[i], p[i]) < 1e-4
    kw = bp.bp_bethe_pairs_fwd(st, e1, ep, (k[3], k[4]))
    pw = bp.bp_bethe_pairs_fwd(st, e1, ep, (k[3], k[4]), plain=True)
    for i in (0, 1, 2):
        assert _rel(kw[i], pw[i]) < 1e-4


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
def test_bp_planes_kernel_matches_plain(cuda):
    rng = np.random.default_rng(4)
    R, n_rep = 40, 3
    n_rot = rng.choice([1, 3, 6], size=R)
    valid = np.arange(6)[None, :] < n_rot[:, None]
    adj = np.triu(rng.random((R, R)) < 0.15, 1)
    adj = adj | adj.T
    E2 = 0.5 * rng.normal(size=(n_rep, 6, 6, R, R))
    E2 = E2 + E2.transpose(0, 2, 1, 4, 3)
    E2 = np.where(adj, E2, 0.0).reshape(n_rep, 36, R, R)
    E1 = np.where(valid, 2.0 * rng.normal(size=(n_rep, R, 6)), 0.0)
    res = np.repeat(np.arange(R), n_rot)
    rot = np.concatenate([np.arange(n) for n in n_rot])
    st = bp.make_statics(res, rot, valid, 128, 0.1, 1000, 1e-6, 2, cuda)
    f32 = dict(dtype=torch.float32, device=cuda)
    e1, e2 = torch.tensor(E1, **f32), torch.tensor(E2, **f32)
    a = torch.tensor(np.broadcast_to(adj, (n_rep, R, R)).copy(), device=cuda)
    P = bpp.boltzmann_planes(e2, st.valid)
    k = _repeatable(lambda: bpp.bp_bethe_planes_fwd(st, e1, P, a))
    p = bpp.bp_bethe_planes_fwd(st, e1, P, a, plain=True)
    for i in (0, 1, 2, 3):                       # F, G1, G2, beliefs
        assert _rel(k[i], p[i]) < 1e-4
    assert k[2].count_nonzero() > 0
    init = (k[3], k[4])
    kw = _repeatable(lambda: bpp.bp_bethe_planes_fwd(st, e1 + 0.05, P, a,
                                                     init))
    pw = bpp.bp_bethe_planes_fwd(st, e1 + 0.05, P, a, init, plain=True)
    for i in (0, 1, 2, 3):
        assert _rel(kw[i], pw[i]) < 1e-4
