"""Seeded synthetic rotamer-BP problems for the tests and the smoke run:
the shapes the shipped bundles do not reach (several beads in a rotamer
slot, the 128-residue cap, enough edges for each layout of the kernels'
solve, a replica without any edge, a residue without a neighbour, replicas
that converge after different sweep counts).  numpy only; the callers turn
the arrays into tensors of their device.
"""

from __future__ import annotations

import numpy as np

NROT = 6
# BP settings of the cases (damping, max_iter, tol, chunk).  The tolerance
# is 1e-4: float32 rounding moves the deviation of the 128-residue cases by
# a few 1e-6, which at a tolerance of 1e-6 or 1e-5 decides the chunk at
# which they stop (the plain version's own sweep counts then differ between
# float32 and float64).  The seeds are ones whose sweep counts stay the same
# for tolerances 25% either side, cold and warm-started on the perturbed
# problem E1 * WARM_SCALE, so two float32 implementations agree on them.
BP_SETTINGS = (0.1, 1000, 1e-4, 2)
# the tolerance at which the values (not the sweep counts) are also compared
TIGHT_TOL = 1e-6
WARM_SCALE = 0.9
# mixed batches of 4 replicas: one without any edge, one residue without a
# neighbour, invalid slots, different sweep counts.  The denser 128-residue
# cases have about 2,400 and 4,800 adjacent directed edges a replica, which
# the kernels' solve holds with its messages only in shared memory (layout
# 1) and in global scratch (layout 2, `bp_pairs.solve_layout`); the others
# run layout 0.
PAIRS_CASES = {
    "one bead a slot": dict(seed=5, n_res=12, m_slot=1),
    "three beads a slot": dict(seed=4, n_res=33, m_slot=3, density=0.2,
                               strength=0.5),
    "128 residues": dict(seed=7, n_res=128, m_slot=1, density=0.04,
                         strength=0.6),
    "128 residues, layout 1": dict(seed=4, n_res=128, m_slot=1,
                                   density=0.15, strength=0.25),
    "128 residues, layout 2": dict(seed=0, n_res=128, m_slot=1, density=0.3,
                                   strength=0.15),
}
PLANES_CASES = {
    "40 residues": dict(seed=0, n_res=40),
    "33 residues": dict(seed=4, n_res=33),
    "128 residues": dict(seed=0, n_res=128, density=0.06),
    "128 residues, layout 1": dict(seed=1, n_res=128, density=0.15,
                                   strength=0.4),
    "128 residues, layout 2": dict(seed=1, n_res=128, density=0.3,
                                   strength=0.25),
}
# the layout each case's replicas with edges take
CASE_LAYOUT = {"128 residues, layout 1": 1, "128 residues, layout 2": 2}
MIXED = dict(n_rep=4, lonely=(3,), empty_replica=2)


def _rotamer_counts(rng, n_res):
    n_rot = rng.choice([1, 3, 6], size=n_res)
    valid = np.arange(NROT)[None, :] < n_rot[:, None]
    return n_rot, valid


def _residue_contacts(rng, n_res, density, lonely):
    near = np.triu(rng.random((n_res, n_res)) < density, 1)
    near = near | near.T
    for i in lonely:
        near[i] = near[:, i] = False
    return near


def pairs_case(seed, n_res=12, m_slot=1, n_rep=3, density=0.35, lonely=(),
               empty_replica=None, strength=1.6):
    """A K2 problem: (E1 (n_rep, R, 6), E_pair (n_rep, n2p, n2p), res, rot,
    valid, n2p).  Each valid slot holds 1 to `m_slot` beads (one slot holds
    `m_slot`); slots beyond a residue's rotamer count are invalid.  The
    bead grid is nonzero on the upper triangle between residues in contact;
    its scale grows with the replica up to `strength`, so the replicas take
    different sweep counts; residues in `lonely` have no contact and replica
    `empty_replica` has no nonzero pair energy at all."""
    rng = np.random.default_rng(seed)
    n_rot, valid = _rotamer_counts(rng, n_res)
    per_slot = rng.integers(1, m_slot + 1, size=(n_res, NROT)) * valid
    per_slot[0, 0] = m_slot
    res = np.repeat(np.arange(n_res), per_slot.sum(1))
    rot = np.concatenate([np.repeat(np.arange(NROT), per_slot[i])
                          for i in range(n_res)])
    n = len(res)
    n2p = -(-n // 128) * 128
    near = _residue_contacts(rng, n_res, density, lonely)
    keep = (np.arange(n)[:, None] < np.arange(n)[None, :]) \
        & near[res[:, None], res[None, :]]
    scale = np.linspace(0.2 * strength, strength, n_rep)[:, None, None]
    E = np.zeros((n_rep, n2p, n2p))
    E[:, :n, :n] = np.where(keep, scale * rng.normal(size=(n_rep, n, n)), 0.0)
    if empty_replica is not None:
        E[empty_replica] = 0.0
    E1 = np.where(valid, rng.normal(size=(n_rep, n_res, NROT)), 0.0)
    return E1, E, res, rot, valid, n2p


def planes_case(seed, n_res=40, n_rep=3, density=0.15, lonely=(),
                empty_replica=None, strength=1.0):
    """A K6 problem: (E1 (n_rep, R, 6), E2 planes (n_rep, 36, R, R), adj
    (n_rep, R, R) bool, res, rot, valid).  One bead per valid slot.  Each
    replica has its own symmetric adjacency and pair energies on its edges
    only, E2[a, b, i, j] = E2[b, a, j, i], their scale growing with the
    replica up to 0.9 `strength`; `lonely` and `empty_replica` as in
    `pairs_case`."""
    rng = np.random.default_rng(seed)
    n_rot, valid = _rotamer_counts(rng, n_res)
    res = np.repeat(np.arange(n_res), n_rot)
    rot = np.concatenate([np.arange(k) for k in n_rot])
    adj = np.stack([_residue_contacts(rng, n_res, density, lonely)
                    for _ in range(n_rep)])
    if empty_replica is not None:
        adj[empty_replica] = False
    scale = np.linspace(0.2, 0.9, n_rep)[:, None, None, None, None]
    E2 = scale * rng.normal(size=(n_rep, NROT, NROT, n_res, n_res))
    E2 = E2 + E2.transpose(0, 2, 1, 4, 3)
    vv = valid.T[:, None, :, None] & valid.T[None, :, None, :]
    E2 = np.where(adj[:, None, None] & vv, E2, 0.0) * strength
    E1 = np.where(valid, 2.0 * rng.normal(size=(n_rep, n_res, NROT)), 0.0)
    return E1, E2.reshape(n_rep, NROT * NROT, n_res, n_res), adj, res, rot, \
        valid
