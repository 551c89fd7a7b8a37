"""The port's unfused pair spline (ops/quadspline.py): plain K5 and K4
against the JAX package, on seeded problems of 2 replicas.

* against `quadspline_pallas` / `quadspline_colsum_pallas` run with
  interpret=True (as tests/test_pallas_quadspline.py runs them), in
  float32: values and the gradients to positions, directions and, for K4,
  the row weights, at rel 2e-4 (the TPU kernels split the table into bf16
  hi and lo halves, pallas_quadspline.py:228-245, which costs ~2^-16 of
  every coefficient);
* against the XLA `pair_coverage` (upside_md_tpu/ops/pairs.py:134) in
  float64: values and gradients at rel 1e-9, for two spline families,
  with K5 taking the same bead tensor on both sides (the rotamer grid:
  autograd sums both cotangents);
* the table cotangents of both against autodiff of the XLA formulation
  (rel 1e-9) and the JAX rules (rel 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upside_md_tpu.ops import pairs as jpairs
from upside_md_tpu.ops.pallas_quadspline import (quadspline_colsum_pallas,
                                                 quadspline_pallas)
from upside_md_torch.ops.quadspline import (PairSpline, quadspline,
                                            quadspline_colsum)

N_REP = 2


def sites(rng, n, spread=3.0):
    """(N_REP, n, 6) positions and unit directions, replicas differing."""
    d = rng.normal(size=(N_REP, n, 3))
    return np.concatenate([spread * rng.normal(size=(1, n, 3))
                           + 0.3 * rng.normal(size=(N_REP, n, 3)),
                           d / np.linalg.norm(d, axis=-1, keepdims=True)], -1)


def problem(seed, n1=150, n2=120, n_t=4, ka=8, k=9):
    rng = np.random.default_rng(seed)
    table = 0.5 * rng.normal(size=(n_t, n_t + 1, 2 * ka + 2 * k))
    t1 = rng.integers(0, n_t, n1)
    t2 = rng.integers(0, n_t + 1, n2)
    mask = rng.random((n1, n2)) > 0.2
    w1 = rng.random((N_REP, n1)) + 0.1
    return table, t1, t2, mask, sites(rng, n1), sites(rng, n2), w1, rng


def bead_problem(seed, n=140, n_t=5, ka=8, k=9):
    """Rotamer-grid shape: one bead set on both sides, upper triangle of
    different residues."""
    rng = np.random.default_rng(seed)
    table = 0.5 * rng.normal(size=(n_t, n_t, 2 * ka + 2 * k))
    t = rng.integers(0, n_t, n)
    res = np.sort(rng.integers(0, n // 3, n))
    mask = (np.arange(n)[:, None] < np.arange(n)[None, :]) \
        & (res[:, None] != res[None, :])
    return table, t, mask, sites(rng, n), rng


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _port_grads(out_fn, args, cot):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = out_fn(*ts)
    grads = torch.autograd.grad((out * torch.as_tensor(cot)).sum(), ts)
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax_grads(out_fn, args, cot):
    out, vjp = jax.vjp(out_fn, *[jnp.asarray(a) for a in args])
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def test_k5_matches_pallas_interpret():
    table, t1, t2, mask, x1, x2, _, rng = problem(0, n1=120, n2=100)
    ps = PairSpline(t1, t2, mask, "cpu")
    f32 = [a.astype(np.float32) for a in (x1, x2)]
    cot = rng.normal(size=(N_REP,) + mask.shape).astype(np.float32)
    tab = torch.tensor(table, dtype=torch.float32)
    out_t, g_t = _port_grads(lambda a, b: quadspline(ps, tab, a, b), f32,
                             cot)

    def jfun(a, b):
        return jax.vmap(lambda p, q: quadspline_pallas(
            (8, 9, 1.0), True, jnp.asarray(table, jnp.float32),
            jnp.asarray(t1), jnp.asarray(t2), p, q, jnp.asarray(mask)))(a, b)

    out_j, g_j = _jax_grads(jfun, f32, cot)
    assert np.count_nonzero(out_j) > 1000
    assert _rel(out_t, out_j) < 2e-4
    for a, b in zip(g_t, g_j):
        assert _rel(a, b) < 2e-4


def test_k4_matches_pallas_interpret():
    table, t1, t2, mask, x1, x2, w1, rng = problem(1, k=7)
    ps = PairSpline(t1, t2, mask, "cpu")
    f32 = [a.astype(np.float32) for a in (x1, x2, w1)]
    cot = rng.normal(size=(N_REP, mask.shape[1])).astype(np.float32)
    tab = torch.tensor(table, dtype=torch.float32)
    out_t, g_t = _port_grads(
        lambda a, b, w: quadspline_colsum(ps, tab, a, b, w), f32, cot)

    def jfun(a, b, w):
        return jax.vmap(lambda p, q, v: quadspline_colsum_pallas(
            (8, 7, 1.0), True, jnp.asarray(table, jnp.float32),
            jnp.asarray(t1), jnp.asarray(t2), p, q, jnp.asarray(mask),
            v))(a, b, w)

    out_j, g_j = _jax_grads(jfun, f32, cot)
    assert _rel(out_t, out_j) < 2e-4
    for a, b in zip(g_t, g_j):                  # x1, x2 and w1
        assert np.abs(b).max() > 0
        assert _rel(a, b) < 2e-4


def _xla_grid(table, t1, t2, mask, ka, k, dx):
    return jax.vmap(lambda a, b: jpairs.pair_coverage(
        jnp.asarray(table), jnp.asarray(t1), jnp.asarray(t2), a, b,
        jnp.asarray(mask), ka, k, dx))


@pytest.mark.parametrize("family", [(8, 9, 1.0), (15, 16, 0.5)])
def test_k5_same_beads_matches_xla_float64(family):
    ka, k, dx = family
    table, t, mask, x, rng = bead_problem(2, ka=ka, k=k)
    ps = PairSpline(t, t, mask, "cpu")
    cot = rng.normal(size=(N_REP,) + mask.shape)
    tab = torch.tensor(table)
    out_t, (g_t,) = _port_grads(lambda a: quadspline(ps, tab, a, a), [x],
                                cot)
    grid = _xla_grid(table, t, t, mask, ka, k, dx)
    out_j, (g_j,) = _jax_grads(lambda a: grid(a, a), [x], cot)
    assert np.count_nonzero(out_j) > 500
    assert _rel(out_t, out_j) < 1e-9
    assert _rel(g_t, g_j) < 1e-9


@pytest.mark.parametrize("family", [(8, 7, 1.0), (15, 12, 0.5)])
def test_k4_matches_xla_float64(family):
    ka, k, dx = family
    table, t1, t2, mask, x1, x2, w1, rng = problem(3, n1=180, n2=160,
                                                   ka=ka, k=k)
    ps = PairSpline(t1, t2, mask, "cpu")
    cot = rng.normal(size=(N_REP, mask.shape[1]))
    tab = torch.tensor(table)
    out_t, g_t = _port_grads(
        lambda a, b, w: quadspline_colsum(ps, tab, a, b, w), [x1, x2, w1],
        cot)
    grid = _xla_grid(table, t1, t2, mask, ka, k, dx)
    out_j, g_j = _jax_grads(
        lambda a, b, w: (w[..., None] * grid(a, b)).sum(1), [x1, x2, w1],
        cot)
    assert _rel(out_t, out_j) < 1e-9
    for a, b in zip(g_t, g_j):
        assert _rel(a, b) < 1e-9


def test_table_cotangent_is_refused():
    """The table cotangents of K5 and K4 (`_table_cotangent`, :753, under
    the pair cotangents of :790-798 and :900-916), float64: against
    autodiff of the XLA `pair_coverage` at rel 1e-9, and against the JAX
    rules at rel 1e-5 (they gather the table through float32 one-hot
    products)."""
    table, t1, t2, mask, x1, x2, w1, rng = problem(4, n1=20, n2=30)
    ps = PairSpline(t1, t2, mask, "cpu")
    tab = torch.tensor(table, requires_grad=True)
    a, b, w = (torch.tensor(v) for v in (x1, x2, w1))
    g5 = rng.normal(size=(N_REP,) + mask.shape)
    g4 = rng.normal(size=(N_REP, mask.shape[1]))
    (d5,) = torch.autograd.grad(
        (quadspline(ps, tab, a, b) * torch.tensor(g5)).sum(), tab)
    (d4,) = torch.autograd.grad(
        (quadspline_colsum(ps, tab, a, b, w) * torch.tensor(g4)).sum(), tab)

    def xla(t):
        grid = jax.vmap(lambda p, q: jpairs.pair_coverage(
            t, jnp.asarray(t1), jnp.asarray(t2), p, q, jnp.asarray(mask),
            8, 9, 1.0))(jnp.asarray(x1), jnp.asarray(x2))
        return (jnp.sum(grid * g5),
                jnp.sum((jnp.asarray(w1)[..., None] * grid).sum(1) * g4))

    def rules(t):
        args = (jnp.asarray(t1), jnp.asarray(t2))
        grid = jax.vmap(lambda p, q: quadspline_pallas(
            (8, 9, 1.0), True, t, *args, p, q, jnp.asarray(mask)))(
            jnp.asarray(x1), jnp.asarray(x2))
        cols = jax.vmap(lambda p, q, v: quadspline_colsum_pallas(
            (8, 9, 1.0), True, t, *args, p, q, jnp.asarray(mask), v))(
            jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w1))
        return jnp.sum(grid * g5), jnp.sum(cols * g4)

    tj = jnp.asarray(table)
    for k, got in enumerate((d5, d4)):
        exact = jax.jit(jax.grad(lambda t: xla(t)[k]))(tj)
        rule = jax.jit(jax.grad(lambda t: rules(t)[k]))(tj)
        assert np.abs(np.asarray(exact)).max() > 0
        assert _rel(got.numpy(), exact) < 1e-9
        assert _rel(got.numpy(), rule) < 1e-5
