"""The port's fused pair block without its env band, K3 (the recomputing
backward), the table cotangents and the prepared-operand memo, against
the JAX package.

The seeded problem of tests/test_torch_fused_pairs.py (6 hbond rows, 7
hydrophobe rows, 5 env probes, 11 beads, float64) goes through

* exact float64 XLA (`reference_outputs`, `env_reference` and their
  autodiff): outputs, input gradients and table cotangents at rel 1e-9;
* the Pallas kernels in interpret mode: `fused_pair_block(fams, True,
  ...)` without the env band, and `fused_pair_block_env` with it under
  UPSIDE_FUSED_RESID=0 (its recomputing backward, `_fused_bwd_kernel`).
  They read the table through a bf16 hi/lo split, so they are held at
  rtol 2e-4 with atol 1e-5 of each array's scale, as in
  test_torch_fused_pairs.py.  Their table cotangents are the XLA rules
  `_table_cotangent` and autodiff of `_env_xla_rowsums`: under a loss
  linear in the outputs they are held at 1e-5 (the rule gathers the
  table in float32), and the port's at 1e-9 to autodiff of exact XLA.

The port's bands are contiguous rows with one weight column; the JAX
kernels' row layout (beads from N1C, two weight columns) is mapped here.
The poisoned-cotangent test records a fault of the JAX recomputing
backward: it multiplies the env cotangent by the mask (pallas_quadspline.py
:1182) and takes the weight cotangents as val * gcs unguarded (:1254-1257),
so a non-finite cotangent in a dead slot gives NaN there; the port selects
and stays finite.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_fused_pairs import (env_args, env_reference, full_args,
                              reference_outputs)
from test_torch_fused_pairs import (_close, dyn_arrays, loss_terms, port_prep,
                                    problem, xla_block)
from upside_md_tpu.ops.pallas_quadspline import (fused_pair_block,
                                                 fused_pair_block_env)
from upside_md_torch import DATA_DIR
from upside_md_torch.config import bundle
from upside_md_torch.ops import fused_pair as fp
from upside_md_torch.system import System


def noenv_prep(prob, tabs=None):
    (fams, tab1, tab2, tab3, t1a, t1b, tc, ma, mb, mc, *_) = prob
    tabs = tabs or [np.asarray(t) for t in (tab1, tab2, tab3)]
    n2 = np.asarray(tc).shape[0]
    return fp.make_prep(
        [np.asarray(t.detach() if isinstance(t, torch.Tensor) else t)
         for t in tabs],
        [np.asarray(t1a), np.asarray(t1b), np.zeros(0, int), np.asarray(tc)],
        [np.asarray(tc), np.asarray(tc), np.zeros(n2, int), np.asarray(tc)],
        [np.asarray(ma), np.asarray(mb), np.zeros((0, n2), bool),
         np.asarray(mc)], None, "cpu", torch.float64)


def port_noenv(prep, dyn, tabs=None, plain=False):
    """(c1, c2, grid) of one replica without the env band."""
    x1a, w1a, x1b, w1b, xb = dyn
    n2 = xb.shape[0]
    x1 = torch.cat([x1a, x1b, xb])[None]
    w1 = torch.cat([w1a, w1b, xb.new_zeros(n2)])[None]
    cov, grid, env = fp.fused_pair_block(prep, x1, w1, xb[None],
                                         xb.new_zeros((1, n2)), plain,
                                         tabs, residuals=True)
    assert env.shape == (1, 0)
    return cov[0, 0], cov[0, 1], grid[0]


def port_env(prep, dyn, tabs=None, residuals=False):
    """(c1, c2, grid, env) of one replica with the env band."""
    x1a, w1a, x1b, w1b, xb, x1e, wcol = dyn
    x1 = torch.cat([x1a, x1b, x1e, xb])[None]
    w1 = torch.cat([w1a, w1b, x1a.new_zeros(x1e.shape[0] + xb.shape[0])])
    cov, grid, env = fp.fused_pair_block(prep, x1, w1[None], xb[None],
                                         wcol[None], False, tabs, residuals)
    return cov[0, 0], cov[0, 1], grid[0], env[0]


def loss3(c1, c2, g, lib):
    return loss_terms(c1, c2, g, c1[:0], lib)


def _grads(fn, arrays, lib_loss):
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(leaves)
    return out, [g.numpy() for g in torch.autograd.grad(
        lib_loss(*out, torch), leaves)]


@pytest.mark.parametrize("seed", [0, 1])
def test_noenv_block_matches_xla(seed):
    prob, envp = problem(seed)
    dyn = dyn_arrays(prob, envp)[:5]
    prep = noenv_prep(prob)
    out, grads = _grads(lambda d: port_noenv(prep, d), dyn, loss3)
    want = jax.jit(reference_outputs, static_argnums=0)(*prob)
    n2 = dyn[4].shape[0]
    c1, c2, grid = (o.detach().numpy() for o in out)
    assert np.all(grid[n2:] == 0.0) and np.all(grid[:, n2:] == 0.0)
    for g, w in zip((c1, c2, grid[:n2, :n2]), want):
        _close(g, w, 1e-9, 1e-12)

    def ref_loss(x1a, w1a, x1b, w1b, xb):
        p = list(prob)
        p[10:15] = [x1a, w1a, x1b, w1b, xb]
        return loss3(*reference_outputs(*p), jnp)

    want_g = jax.jit(jax.grad(ref_loss, argnums=tuple(range(5))))(
        *[jnp.asarray(d) for d in dyn])
    for a, b in zip(grads, want_g):
        assert np.abs(np.asarray(b)).max() > 0
        _close(a, b, 1e-9, 1e-12)


def test_noenv_block_matches_interpret():
    prob, envp = problem(0)
    dyn = dyn_arrays(prob, envp)[:5]
    prep = noenv_prep(prob)
    out, grads = _grads(lambda d: port_noenv(prep, d), dyn, loss3)
    fams = prob[0]
    statics, _ = full_args(prob)

    def jf(*d):
        return fused_pair_block(fams, True, *statics, *d)

    args = [jnp.asarray(d) for d in dyn]
    want, want_g = jax.jit(lambda *d: (jf(*d), jax.grad(
        lambda *e: loss3(*jf(*e), jnp), argnums=tuple(range(5)))(*d)))(
        *args)
    for g, w in zip(out, want):
        _close(g.detach().numpy(), w, 2e-4, 1e-5)
    for a, b in zip(grads, want_g):
        _close(a, b, 2e-4, 1e-5)


def test_k3_env_band_matches_recomputing_vjp(monkeypatch):
    """K3 with the env band (residuals=False) against the JAX VJP under
    UPSIDE_FUSED_RESID=0, and against exact XLA and K1's backward."""
    monkeypatch.setenv("UPSIDE_FUSED_RESID", "0")
    prob, envp = problem(1)
    dyn = dyn_arrays(prob, envp)
    prep = port_prep(prob, envp)
    out, g_k3 = _grads(lambda d: port_env(prep, d, residuals=False), dyn,
                       loss_terms)
    _, g_k1 = _grads(lambda d: port_env(prep, d, residuals=True), dyn,
                     loss_terms)
    fams = prob[0]
    statics, _ = env_args(prob, envp)
    args = [jnp.asarray(d) for d in dyn]

    def jf(*d):
        return fused_pair_block_env(fams, True, *statics, *d)

    want_g = jax.jit(jax.grad(lambda *d: loss_terms(*jf(*d), jnp),
                              argnums=tuple(range(7))))(*args)
    xla_g = jax.jit(jax.grad(
        lambda *d: loss_terms(*xla_block(prob, envp)(*d), jnp),
        argnums=tuple(range(7))))(*args)
    for a, b, c, k1 in zip(g_k3, want_g, xla_g, g_k1):
        assert np.abs(np.asarray(c)).max() > 0
        _close(a, b, 2e-4, 1e-5)
        _close(a, c, 1e-9, 1e-12)
        _close(a, k1, 1e-12, 1e-14)


def _linear_weights(shapes, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s) for s in shapes]


@pytest.mark.parametrize("layout", ["noenv", "env_residuals",
                                    "env_recompute"])
def test_table_cotangents_match_jax_rules(layout):
    """Cotangents of every table under a loss linear in the outputs, so
    the JAX cotangents are its rules (`_table_cotangent`, autodiff of
    `_env_xla_rowsums`) whatever the kernel's precision: against autodiff
    of the exact XLA formulation at rel 1e-9, and against the JAX rules at
    rel 1e-5 (`_table_cotangent` gathers the table through float32
    one-hot products, :773-777, so it carries float32 rounding)."""
    prob, envp = problem(0)
    fams = prob[0]
    env = layout != "noenv"
    np_tabs = [np.asarray(t) for t in prob[1:4]] \
        + ([np.asarray(envp[0])] if env else [])
    tabs = [torch.tensor(t, requires_grad=True) for t in np_tabs]
    dyn = [torch.tensor(d) for d in dyn_arrays(prob, envp)]
    if env:
        prep = port_prep(prob, envp)
        out = port_env(prep, dyn, tabs, layout == "env_residuals")
    else:
        prep = noenv_prep(prob)
        out = port_noenv(prep, dyn[:5], tabs + [None])
    ws = _linear_weights([tuple(o.shape) for o in out])
    got = torch.autograd.grad(
        sum((o * torch.tensor(w)).sum() for o, w in zip(out, ws)), tabs)

    statics = env_args(prob, envp)[0] if env else full_args(prob)[0]
    n_tab = len(np_tabs)
    d = [jnp.asarray(a) for a in dyn_arrays(prob, envp)]
    n2 = d[4].shape[0]

    def jloss(*t):
        st = tuple(t) + tuple(statics[n_tab:])
        o = (fused_pair_block_env(fams, True, *st, *d) if env
             else fused_pair_block(fams, True, *st, *d[:5]))
        return sum(jnp.sum(a * jnp.asarray(w)) for a, w in zip(o, ws))

    def xla_loss(*t):
        p = list(prob)
        p[1:4] = t[:3]
        o = list(reference_outputs(*p))
        if env:
            e = list(envp)
            e[0] = t[3]
            o.append(env_reference(e, d[4]))
        w = list(ws)
        w[2] = w[2][:n2, :n2]
        return sum(jnp.sum(a * jnp.asarray(b)) for a, b in zip(o, w))

    args = [jnp.asarray(t) for t in np_tabs]
    rule = jax.jit(jax.grad(jloss, argnums=tuple(range(n_tab))))(*args)
    exact = jax.jit(jax.grad(xla_loss, argnums=tuple(range(n_tab))))(*args)
    for a, b, c in zip(got, rule, exact):
        assert np.abs(np.asarray(c)).max() > 0
        _close(a.numpy(), c, 1e-9, 1e-12)
        _close(a.numpy(), b, 1e-5, 1e-6)


def _poisoned(prob, envp):
    """Cotangents with NaN/Inf in dead slots: the padded and masked grid,
    cutoff-dead pairs, an env row whose pairs are all masked, and a
    coverage column no hbond row reaches."""
    prob, envp = list(prob), list(envp)
    ma = np.asarray(prob[7]).copy()
    ma[:, 3] = False
    prob[7] = jnp.asarray(ma)
    me = np.asarray(envp[3]).copy()
    me[2] = False
    envp[3] = jnp.asarray(me)
    return prob, envp


def _cotangents(grid, n2, mask_p, c1, ev, poison):
    gbar = np.ones(grid.shape)
    gc1, gev = np.ones(c1.shape), np.ones(ev.shape)
    if poison:
        gbar[n2:, :] = np.nan
        gbar[:, n2:] = np.inf
        gbar[:n2, :n2][np.tril_indices(n2, k=-1)] = np.nan
        gbar[:n2, :n2][mask_p & (grid[:n2, :n2] == 0.0)] = np.inf
        gc1[3] = np.nan
        gev[2:3] = np.nan
    return gc1, gbar, gev


def test_k3_poisoned_dead_slots_stay_finite(monkeypatch):
    prob, envp = _poisoned(*problem(0))
    dyn = dyn_arrays(prob, envp)
    n2 = dyn[4].shape[0]

    def port_grads(poison, env):
        leaves = [torch.tensor(d, requires_grad=True)
                  for d in (dyn if env else dyn[:5])]
        if env:
            prep = port_prep(prob, envp)
            c1, c2, grid, ev = port_env(prep, leaves, residuals=False)
        else:
            prep = noenv_prep(prob)
            c1, c2, grid = port_noenv(prep, leaves)
            ev = c1[:0]
        gc1, gbar, gev = _cotangents(
            grid.detach().numpy(), n2, prep.mask[prep.r_p:].numpy() > 0,
            c1, ev, poison)
        outs = (c1, c2, grid) + ((ev,) if env else ())
        cots = (torch.tensor(gc1), torch.ones_like(c2), torch.tensor(gbar)) \
            + ((torch.tensor(gev),) if env else ())
        return [g.numpy() for g in torch.autograd.grad(outs, leaves, cots)]

    for env in (False, True):
        clean, dirty = port_grads(False, env), port_grads(True, env)
        for c, d in zip(clean, dirty):
            assert np.all(np.isfinite(d))
            np.testing.assert_array_equal(c, d)

    # observed in the JAX package: the same cotangents give NaN through
    # the recomputing backward (hbond weights from val * gcs, env rows and
    # bead columns from genv * m)
    monkeypatch.setenv("UPSIDE_FUSED_RESID", "0")
    fams = prob[0]
    statics, _ = env_args(prob, envp)
    args = [jnp.asarray(d) for d in dyn]
    out, vjp = jax.vjp(jax.jit(lambda *d: fused_pair_block_env(
        fams, True, *statics, *d)), *args)
    mask_p = np.asarray(prob[9])
    gc1, gbar, gev = _cotangents(np.asarray(out[2]), n2, mask_p, out[0],
                                 out[3], True)
    jg = vjp((jnp.asarray(gc1), jnp.ones_like(out[1]), jnp.asarray(gbar),
              jnp.asarray(gev)))
    assert not np.all(np.isfinite(np.asarray(jg[1])))      # w1a
    assert not np.all(np.isfinite(np.asarray(jg[5])))      # x1e


def test_prepared_memo_follows_in_place_update():
    """An in-place update of a table (what torch.optim does) reaches the
    next evaluation: the memo keys on the tensors' versions."""
    specs, pos = bundle.load(os.path.join(DATA_DIR,
                                          "trp_cage_full_synth.npz"))
    system = System(len(pos), specs, "cpu", torch.float64)
    x = torch.tensor(pos[None], dtype=torch.float64)
    with torch.no_grad():
        e0 = system.evaluate(x)[0]
        prep0 = system.fused_prepared()
        system.params["rotamer"]["interaction_param"].add_(0.05)
        e1 = system.evaluate(x)[0]
        assert system.fused_prepared() is not prep0
        fresh = System(len(pos), specs, "cpu", torch.float64)
        fresh.params["rotamer"]["interaction_param"].add_(0.05)
        e2 = fresh.evaluate(x)[0]
    assert abs(e1.item() - e0.item()) > 1e-6
    assert abs(e1.item() - e2.item()) <= 1e-12 * max(1.0, abs(e2.item()))
