"""The port's fused pair block (ops/fused_pair.py) against the JAX package.

The same seeded problem (tests/test_fused_pairs.py builders: 6 hbond rows,
7 hydrophobe rows, 5 env probes, 11 beads, 1 replica) goes through

* the plain XLA formulation of the three pair terms and the env band
  (exact float64): outputs at rel 1e-9, input gradients at rel 1e-7;
* `fused_pair_block_env_prep(meta, True, ...)`, the Pallas kernel in
  interpret mode.  It reads its spline table through a bf16 hi/lo split
  (~2^-17 relative per coefficient, up to 7e-5 relative on a value), so it
  is held at the JAX suite's own fused-vs-XLA tolerance, rtol 2e-4 with
  atol 1e-5 of each array's scale.

The robustness checks port tests/test_resid_robustness.py: non-finite
cotangents in dead slots must not reach the gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_fused_pairs import (env_reference, make_env_problem, make_problem,
                              reference_outputs)
from upside_md_tpu.ops.pallas_quadspline import (_fused_prep_static,
                                                 fused_pair_block_env_prep)
from upside_md_torch.ops import fused_pair as fp


def problem(seed=0):
    rng = np.random.default_rng(seed)
    prob = make_problem(rng, n_a=6, n_b=7, n2=11)
    envp = make_env_problem(rng, prob, n_e=5)
    return prob, envp


def port_prep(prob, envp, device="cpu", dtype=torch.float64):
    (fams, tab1, tab2, tab3, t1a, t1b, tc, ma, mb, mc, *_) = prob
    tab4, t1e, t2e, me, _, _ = envp
    a = [np.asarray(x) for x in (tab1, tab2, tab3)]
    return fp.make_prep(
        a, [np.asarray(t) for t in (t1a, t1b, t1e, tc)],
        [np.asarray(t) for t in (tc, tc, t2e, tc)],
        [np.asarray(m) for m in (ma, mb, me, mc)], np.asarray(tab4),
        device, dtype)


def dyn_arrays(prob, envp):
    (*_, x1a, w1a, x1b, w1b, xb) = prob
    return [np.asarray(v) for v in (x1a, w1a, x1b, w1b, xb, envp[4],
                                    envp[5])]


def port_block(prep, dyn, plain=False):
    """(c1, c2, grid, env) of one replica from the JAX-style operands."""
    x1a, w1a, x1b, w1b, xb, x1e, wcol = dyn
    B = 1
    x1 = torch.cat([x1a[None], x1b[None], x1e[None], xb[None]], dim=1)
    w1 = torch.cat([w1a[None], w1b[None],
                    x1a.new_zeros((B, prep.n_e + prep.n2))], dim=1)
    cov, grid, env = fp.fused_pair_block(prep, x1, w1, xb[None], wcol[None],
                                         plain)
    return cov[0, 0], cov[0, 1], grid[0], env[0]


def jax_block(prob, envp):
    (fams, tab1, tab2, tab3, t1a, t1b, tc, ma, mb, mc, *_) = prob
    tab4, t1e, t2e, me, _, _ = envp
    n = (t1a.shape[0], t1b.shape[0], tc.shape[0], t1e.shape[0])
    prep, meta = _fused_prep_static(
        fams, (tab1, tab2, tab3), (t1a, t1b, tc), (tc, tc, tc),
        (ma, mb, mc), n, (tab4, t1e, t2e, me))

    def f(*dyn):
        return fused_pair_block_env_prep(meta, True, *prep, *dyn)
    return f


def xla_block(prob, envp):
    """Exact float64 reference of (c1, c2, grid, env) as a function of the
    dynamic operands."""
    def f(x1a, w1a, x1b, w1b, xb, x1e, wcol):
        p = list(prob)
        p[10:15] = [x1a, w1a, x1b, w1b, xb]
        e = list(envp)
        e[4:6] = [x1e, wcol]
        c1, c2, g = reference_outputs(*p)
        return c1, c2, g, env_reference(e, xb)
    return f


def loss_terms(c1, c2, g, ev, lib):
    return (lib.sum(lib.sin(c1)) + 2.0 * lib.sum(lib.cos(c2))
            + lib.sum(g * g) + lib.sum(lib.sin(2.0 * ev)))


def _close(got, want, rtol, scale_atol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = scale_atol * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_outputs_match_xla(seed):
    prob, envp = problem(seed)
    got = port_block(port_prep(prob, envp),
                     [torch.tensor(d) for d in dyn_arrays(prob, envp)])
    c1r, c2r, gr, er = jax.jit(xla_block(prob, envp))(
        *[jnp.asarray(d) for d in dyn_arrays(prob, envp)])
    n2 = np.asarray(gr).shape[0]
    _close(got[0].detach().numpy(), c1r, 1e-9, 1e-12)
    _close(got[1].detach().numpy(), c2r, 1e-9, 1e-12)
    grid = got[2].detach().numpy()
    assert np.all(grid[n2:] == 0.0) and np.all(grid[:, n2:] == 0.0)
    _close(grid[:n2, :n2], gr, 1e-9, 1e-12)
    _close(got[3].detach().numpy(), er, 1e-9, 1e-12)
    assert np.count_nonzero(grid) > 3 and np.any(got[3].detach().numpy())


def test_fused_outputs_match_interpret():
    prob, envp = problem(0)
    dyn = dyn_arrays(prob, envp)
    got = port_block(port_prep(prob, envp),
                     [torch.tensor(d) for d in dyn])
    want = jax_block(prob, envp)(*[jnp.asarray(d) for d in dyn])
    for g, w in zip(got, want):
        _close(g.detach().numpy(), w, 2e-4, 1e-5)


def _port_grads(prob, envp):
    leaves = [torch.tensor(d, requires_grad=True)
              for d in dyn_arrays(prob, envp)]
    out = port_block(port_prep(prob, envp), leaves)
    return [g.numpy() for g in torch.autograd.grad(loss_terms(*out, torch),
                                                   leaves)]


def _jax_grads(f, prob, envp):
    args = [jnp.asarray(d) for d in dyn_arrays(prob, envp)]
    return jax.jit(jax.grad(lambda *d: loss_terms(*f(*d), jnp),
                            argnums=tuple(range(7))))(*args)


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_gradients_match_xla(seed):
    prob, envp = problem(seed)
    for a, c in zip(_port_grads(prob, envp),
                    _jax_grads(xla_block(prob, envp), prob, envp)):
        _close(a, c, 1e-7, 1e-10)


def test_fused_gradients_match_interpret():
    prob, envp = problem(0)
    for a, b in zip(_port_grads(prob, envp),
                    _jax_grads(jax_block(prob, envp), prob, envp)):
        _close(a, b, 2e-4, 1e-5)


def _poisoned_grads(prep, dyn, poison, cov_poison=False):
    leaves = [torch.tensor(d, requires_grad=True) for d in dyn]
    c1, c2, grid, ev = port_block(prep, leaves)
    n2 = dyn[4].shape[0]
    gbar = np.ones(grid.shape)
    gc1 = np.ones(c1.shape)
    if poison:
        gbar[n2:, :] = np.nan
        gbar[:, n2:] = np.inf
        gbar[:n2, :n2][np.tril_indices(n2, k=-1)] = np.nan
        # mask-alive pairs beyond the cutoff evaluate to exactly 0
        mask = prep.mask[prep.r_p:].numpy().astype(bool)
        dead = mask & (grid[:n2, :n2].detach().numpy() == 0.0)
        gbar[:n2, :n2][dead] = np.inf
    if cov_poison:
        gc1[np.asarray(prep.mask[:prep.r_b].numpy()).sum(0) == 0] = np.nan
    grads = torch.autograd.grad(
        (c1, c2, grid, ev), leaves,
        (torch.as_tensor(gc1), torch.ones_like(c2), torch.as_tensor(gbar),
         torch.ones_like(ev)))
    return [g.numpy() for g in grads]


def test_resid_grads_finite_with_poisoned_dead_slots():
    prob, envp = problem(0)
    dyn = dyn_arrays(prob, envp)
    prep = port_prep(prob, envp)
    clean = _poisoned_grads(prep, dyn, False)
    dirty = _poisoned_grads(prep, dyn, True)
    for c, d in zip(clean, dirty):
        assert np.all(np.isfinite(d))
        np.testing.assert_array_equal(c, d)


def test_weight_cotangent_guard():
    """A non-finite coverage cotangent on a column no hbond row reaches
    (all masked) stays out of the weight cotangents; the JAX kernel takes
    it unguarded (pallas_quadspline.py:1254, 1381)."""
    prob, envp = problem(0)
    prob = list(prob)
    ma = np.asarray(prob[7]).copy()
    ma[:, 3] = False
    prob[7] = jnp.asarray(ma)
    dyn = dyn_arrays(prob, envp)
    prep = port_prep(prob, envp)
    clean = _poisoned_grads(prep, dyn, False)
    dirty = _poisoned_grads(prep, dyn, False, cov_poison=True)
    for c, d in zip(clean, dirty):
        assert np.all(np.isfinite(d))
        np.testing.assert_array_equal(c, d)


def test_prep_matches_jax_meta():
    """Row bands, padding and cutoffs agree with `_fused_meta`."""
    from upside_md_tpu.ops.pallas_quadspline import _fused_meta
    prob, envp = problem(0)
    prep = port_prep(prob, envp)
    fams = prob[0]
    meta = _fused_meta(fams, (2, 3, 5), (6, 7, 11, 5), True)
    (fam, _, _, kcut_cov, kcut_pair, _, n2p, n2, _, n_a, n_b, n_e) = meta
    assert (prep.r_b, prep.r_e - prep.r_b, prep.n_e, prep.n2, prep.n2p) \
        == (n_a, n_b, n_e, n2, n2p)
    assert (prep.ka, prep.k, prep.inv_dx) == fam
    assert (prep.kcut_cov, prep.kcut_pair) == (kcut_cov, kcut_pair)
