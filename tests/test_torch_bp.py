"""The port's bead-space BP (ops/bp_pairs.py) against the JAX package.

A seeded problem (9 residues with 1, 3 or 6 rotamers, one bead per
rotamer, sparse bead contacts so that some residue pairs are not adjacent)
goes through

* `_bp_solve` + `bethe_free_energy` (upside_md_tpu/nodes/rotamer.py) with
  jax.grad, given the port's adjacency (residue pairs with any nonzero
  summed energy): beliefs, F and the envelope gradients;
* `bp_bethe_pairs(static, True, False, ...)`, the Pallas mega-kernel in
  interpret mode, whose adjacency is every residue pair: F and dF/dE1
  everywhere, dF/dE_pair on adjacent residue pairs (elsewhere the kernel
  returns pair-marginal gradients of identity edges, which its pair-kernel
  cutoff mask annihilates downstream).

BP tol is 1e-6; beliefs agree to 1e-6, F and gradients at rel 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upside_md_tpu.nodes.rotamer import (_bp_solve, _extrapolate_beliefs,
                                         bethe_free_energy)
from upside_md_tpu.ops.pallas_bp import _scatter_onehots, bp_bethe_pairs
from upside_md_torch.nodes.rotamer import extrapolate_beliefs
from upside_md_torch.ops import bp_pairs as bp

DAMPING, MAX_ITER, TOL, CHUNK = 0.1, 1000, 1e-6, 2


def make_problem(seed, n_res=9, contact=0.35):
    rng = np.random.default_rng(seed)
    n_rot = rng.choice([1, 3, 6], size=n_res)
    res = np.repeat(np.arange(n_res), n_rot)
    rot = np.concatenate([np.arange(n) for n in n_rot])
    valid = np.arange(6)[None, :] < n_rot[:, None]
    n = len(res)
    E = rng.normal(scale=1.5, size=(n, n))
    keep = (np.arange(n)[:, None] < np.arange(n)[None, :]) \
        & (res[:, None] != res[None, :])
    # contacts between a random subset of residue pairs only
    near = rng.random((n_res, n_res)) < contact
    near = near | near.T
    keep &= near[res[:, None], res[None, :]]
    E = np.where(keep, E, 0.0)
    E1 = np.where(valid, rng.normal(size=(n_res, 6)), 0.0)
    return E1, E, res, rot, valid


def port_statics(res, rot, valid, tol=TOL, device="cpu"):
    return bp.make_statics(res, rot, valid, 128, DAMPING, MAX_ITER, tol,
                           CHUNK, device)


def padded(E):
    out = np.zeros((128, 128))
    out[:E.shape[0], :E.shape[1]] = E
    return out


def port_solve(E1, E, res, rot, valid, init=None):
    st = port_statics(res, rot, valid)
    e1 = torch.tensor(E1[None], requires_grad=True)
    ep = torch.tensor(padded(E)[None], requires_grad=True)
    F, nb, eb, dev, it = bp.bp_bethe_pairs(st, e1, ep, init)
    g1, gE = torch.autograd.grad(F.sum(), (e1, ep))
    return F[0].item(), g1[0].numpy(), gE[0].numpy()[:len(res), :len(res)], \
        nb, eb, it


def port_adjacency(E, res, rot, valid):
    st = port_statics(res, rot, valid)
    E2 = bp.scatter_pairs(st, torch.tensor(padded(E)[None]))[0]
    R = valid.shape[0]
    return ((E2 != 0).any(-1).any(-1) & ~torch.eye(R, dtype=torch.bool)) \
        .numpy()


def jax_reference(E1, E, res, rot, valid, adj, init=None):
    R = valid.shape[0]
    oh = np.zeros((len(res), R * 6))
    oh[np.arange(len(res)), res * 6 + rot] = 1.0
    vj = jnp.asarray(valid)

    def F(E1_, E_):
        E2u = (oh.T @ E_ @ oh).reshape(R, 6, R, 6).transpose(0, 2, 1, 3)
        E2 = E2u + jnp.transpose(E2u, (1, 0, 3, 2))
        off = jnp.min(jnp.where(vj, E1_, jnp.inf), -1)
        pr = jnp.where(vj, jnp.exp(off[:, None] - E1_), 0.0)
        P = jnp.exp(-E2)
        nb, eb, it = _bp_solve(jax.lax.stop_gradient(pr),
                               jax.lax.stop_gradient(P), jnp.asarray(adj),
                               vj, DAMPING, MAX_ITER, TOL, CHUNK, init=init,
                               return_iters=True)
        return bethe_free_energy(E1_, off, P, jnp.asarray(adj), vj, nb,
                                 eb), (nb, eb, it)

    (f, aux), grads = jax.value_and_grad(F, argnums=(0, 1), has_aux=True)(
        jnp.asarray(E1), jnp.asarray(E))
    return float(f), np.asarray(grads[0]), np.asarray(grads[1]), aux


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cold_solve_matches_bp_solve(seed):
    E1, E, res, rot, valid = make_problem(seed)
    adj = port_adjacency(E, res, rot, valid)
    assert adj.sum() < adj.size - adj.shape[0]     # some non-edges
    f, g1, gE, nb, eb, it = port_solve(E1, E, res, rot, valid)
    fj, g1j, gEj, (nbj, ebj, itj) = jax_reference(E1, E, res, rot, valid,
                                                   adj)
    assert int(it[0]) == int(itj)
    assert _rel(nb[0].numpy(), nbj) < 1e-6
    assert abs(f - fj) <= 1e-4 * max(1.0, abs(fj))
    assert _rel(g1, g1j) < 1e-4
    assert _rel(gE, gEj) < 1e-4


@pytest.mark.parametrize("seed", [0, 1])
def test_warm_extrapolated_solve_matches(seed):
    """Warm start from an nb-only log-space extrapolation of two earlier
    solutions, as the MD cache does (rotamer.py:294-351, 393-416)."""
    E1, E, res, rot, valid = make_problem(seed)
    adj = port_adjacency(E, res, rot, valid)
    _, _, _, nb0, eb0, _ = port_solve(E1, E, res, rot, valid)
    E1b = E1 + 0.05 * np.where(valid, np.random.default_rng(9).normal(
        size=E1.shape), 0.0)
    _, _, _, nb1, eb1, _ = port_solve(E1b, E, res, rot, valid)
    nbx = extrapolate_beliefs(nb1, nb0)
    nbx_j, _ = _extrapolate_beliefs((jnp.asarray(nb1[0].numpy()),
                                     jnp.asarray(eb1[0].numpy())),
                                    (jnp.asarray(nb0[0].numpy()),
                                     jnp.asarray(eb1[0].numpy())), 1.0)
    assert _rel(nbx[0].numpy(), nbx_j) < 1e-12
    E1c = E1b + (E1b - E1)
    f, g1, gE, nb, _, it = port_solve(E1c, E, res, rot, valid,
                                      init=(nbx, eb1))
    fj, g1j, gEj, (nbj, _, itj) = jax_reference(
        E1c, E, res, rot, valid, adj,
        init=(np.asarray(nbx_j), eb1[0].numpy()))
    assert int(it[0]) == int(itj)
    assert _rel(nb[0].numpy(), nbj) < 1e-6
    assert abs(f - fj) <= 1e-4 * max(1.0, abs(fj))
    assert _rel(g1, g1j) < 1e-4 and _rel(gE, gEj) < 1e-4


def test_matches_pallas_interpret():
    E1, E, res, rot, valid = make_problem(3)
    adj = port_adjacency(E, res, rot, valid)
    f, g1, gE, _, _, _ = port_solve(E1, E, res, rot, valid)
    S6 = _scatter_onehots(res, rot, 128)
    static = (valid.shape[0], DAMPING, MAX_ITER, TOL, CHUNK)

    def fk(E1_, E_):
        F, _, _ = bp_bethe_pairs(static, True, False, E1_, E_,
                                 jnp.asarray(S6), jnp.asarray(S6.T),
                                 jnp.asarray(valid), None)
        return F

    E1f = jnp.asarray(E1, jnp.float32)
    Ef = jnp.asarray(E, jnp.float32)
    fj, (g1j, gEj) = jax.value_and_grad(fk, argnums=(0, 1))(E1f, Ef)
    assert abs(f - float(fj)) <= 1e-4 * max(1.0, abs(float(fj)))
    assert _rel(g1, g1j) < 1e-4
    pair_adj = adj[res[:, None], res[None, :]]
    scale = np.abs(np.asarray(gEj)[pair_adj]).max()
    assert np.abs(gE - np.asarray(gEj))[pair_adj].max() < 1e-4 * scale


def test_bead_gradient_is_symmetric_and_masked():
    E1, E, res, rot, valid = make_problem(4)
    _, _, gE, _, _, _ = port_solve(E1, E, res, rot, valid)
    np.testing.assert_array_equal(gE, gE.T)
    assert np.all(gE[res[:, None] == res[None, :]] == 0.0)
