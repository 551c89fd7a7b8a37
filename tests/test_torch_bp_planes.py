"""The port's residue-plane BP (ops/bp_planes.py, plain K6) against the JAX
package, on seeded problems of 2 replicas (residues with 1 to 6 valid
rotamers, a sparse symmetric adjacency, pair energies on the edges only).

* against `_bp_solve` + `jax.grad(bethe_free_energy)`
  (upside_md_tpu/nodes/rotamer.py:60-170) in float64, cold and warm: F,
  G1 = dF/dE1, G2 = dF/dE2 (planes) and the beliefs at rel 1e-6, sweep
  counts equal;
* against `bp_bethe_pallas(static, True, ...)`, the TPU kernel in
  interpret mode (as tests/test_pallas_bp.py runs it), on the first
  replica, cold and warm from its own converged messages: F, G1 and G2 at
  rel 1e-4 (float32 there, float64 here).

BP tol is 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upside_md_tpu.nodes.rotamer import _bp_solve, bethe_free_energy
from upside_md_tpu.ops.pallas_bp import bp_bethe_pallas
from upside_md_torch.ops import bp_planes as bpp
from upside_md_torch.ops.bp_pairs import make_statics

DAMPING, MAX_ITER, TOL, CHUNK = 0.1, 1000, 1e-6, 2
N_REP = 2


def make_problem(seed, R=20, density=0.2):
    rng = np.random.default_rng(seed)
    n_rot = rng.integers(1, 7, size=R)
    valid = np.arange(6)[None, :] < n_rot[:, None]
    adj = np.triu(rng.random((R, R)) < density, 1)
    adj = adj | adj.T
    E2 = 0.5 * rng.normal(size=(N_REP, 6, 6, R, R))
    E2 = E2 + E2.transpose(0, 2, 1, 4, 3)          # E2[a,b,i,j] = E2[b,a,j,i]
    vv = valid.T[:, None, :, None] & valid.T[None, :, None, :]
    E2 = np.where(adj & vv, E2, 0.0).reshape(N_REP, 36, R, R)
    E1 = np.where(valid, 2.0 * rng.normal(size=(N_REP, R, 6)), 0.0)
    return E1, E2, np.broadcast_to(adj, (N_REP, R, R)).copy(), valid


def statics(valid):
    R = valid.shape[0]
    res = np.repeat(np.arange(R), 6)[valid.ravel()]
    rot = np.tile(np.arange(6), R)[valid.ravel()]
    return make_statics(res, rot, valid, 128, DAMPING, MAX_ITER, TOL, CHUNK,
                        "cpu")


def port(E1, E2, adj, valid, init=None):
    st = statics(valid)
    e1 = torch.tensor(E1, requires_grad=True)
    e2 = torch.tensor(E2, requires_grad=True)
    F, nb, eb, dev, it = bpp.bp_bethe_planes(st, e1, e2, torch.tensor(adj),
                                             init)
    g1, g2 = torch.autograd.grad(F.sum(), (e1, e2))
    return dict(F=F.detach().numpy(), G1=g1.numpy(), G2=g2.numpy(), nb=nb,
                eb=eb, it=it.numpy())


def xla_reference(E1, E2p, adj, valid, init=None):
    """One replica through `_bp_solve` and `bethe_free_energy`."""
    R = E1.shape[0]
    vj = jnp.asarray(valid)
    aj = jnp.asarray(adj)

    def F(E1_, E2p_):
        E2 = jnp.transpose(E2p_.reshape(6, 6, R, R), (2, 3, 0, 1))
        off = jnp.min(jnp.where(vj, E1_, jnp.inf), -1)
        pr = jnp.where(vj, jnp.exp(off[:, None] - E1_), 0.0)
        P = jnp.exp(-E2)
        nb, eb, it = _bp_solve(jax.lax.stop_gradient(pr),
                               jax.lax.stop_gradient(P), aj, vj, DAMPING,
                               MAX_ITER, TOL, CHUNK, init=init,
                               return_iters=True)
        return bethe_free_energy(E1_, off, P, aj, vj, nb, eb), (nb, eb, it)

    (f, (nb, eb, it)), (g1, g2) = jax.value_and_grad(
        F, argnums=(0, 1), has_aux=True)(jnp.asarray(E1), jnp.asarray(E2p))
    return dict(F=float(f), G1=np.asarray(g1), G2=np.asarray(g2),
                nb=np.asarray(nb), eb=np.asarray(eb), it=int(it))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _check_xla(got, want, r):
    assert int(got["it"][r]) == want["it"]
    assert _rel(got["nb"][r].numpy(), want["nb"]) < 1e-6
    assert abs(got["F"][r] - want["F"]) <= 1e-6 * max(1.0, abs(want["F"]))
    assert _rel(got["G1"][r], want["G1"]) < 1e-6
    assert _rel(got["G2"][r], want["G2"]) < 1e-6


@pytest.mark.parametrize("seed", [0, 1])
def test_cold_and_warm_match_bp_solve(seed):
    E1, E2, adj, valid = make_problem(seed)
    cold = port(E1, E2, adj, valid)
    for r in range(N_REP):
        _check_xla(cold, xla_reference(E1[r], E2[r], adj[r], valid), r)
    # warm: a perturbed problem from the converged beliefs and messages
    E1b = E1 + 0.05 * np.where(valid, np.random.default_rng(9).normal(
        size=E1.shape), 0.0)
    warm = port(E1b, E2, adj, valid, init=(cold["nb"], cold["eb"]))
    for r in range(N_REP):
        want = xla_reference(E1b[r], E2[r], adj[r], valid,
                             init=(cold["nb"][r].numpy(),
                                   cold["eb"][r].numpy()))
        _check_xla(warm, want, r)
    assert warm["it"].max() < cold["it"].max()


def test_matches_pallas_interpret():
    E1, E2, adj, valid = make_problem(2, R=16)
    R = valid.shape[0]
    static = (R, DAMPING, MAX_ITER, TOL, CHUNK)
    cold = port(E1, E2, adj, valid)
    f32 = jnp.float32

    def fk(E1_, E2_, init=None):
        F, nb, eb = bp_bethe_pallas(static, True, E1_, E2_,
                                    jnp.asarray(adj[0]), jnp.asarray(valid),
                                    init)
        return F, (nb, eb)

    (fj, (nb, eb)), (g1j, g2j) = jax.value_and_grad(
        fk, argnums=(0, 1), has_aux=True)(jnp.asarray(E1[0], f32),
                                          jnp.asarray(E2[0], f32))
    assert abs(cold["F"][0] - float(fj)) <= 1e-4 * max(1.0, abs(float(fj)))
    assert _rel(cold["G1"][0], g1j) < 1e-4
    assert _rel(cold["G2"][0], g2j) < 1e-4

    # warm: each side from its own converged state, on a new problem
    E1b = E1 + 0.1
    (fw, _), (g1w, g2w) = jax.value_and_grad(
        lambda a, b: fk(a, b, (nb, eb)), argnums=(0, 1), has_aux=True)(
        jnp.asarray(E1b[0], f32), jnp.asarray(E2[0], f32))
    warm = port(E1b, E2, adj, valid, init=(cold["nb"], cold["eb"]))
    assert abs(warm["F"][0] - float(fw)) <= 1e-4 * max(1.0, abs(float(fw)))
    assert _rel(warm["G1"][0], g1w) < 1e-4
    assert _rel(warm["G2"][0], g2w) < 1e-4
