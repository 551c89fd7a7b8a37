"""The plain versions of the BP kernels' compact-edge passes
(upside_md_torch/ops/bp_pairs.py: `compact_edges`, `compact_factors`,
`compact_messages`, `dense_messages`, `dense_pair_gradient`,
`solve_layout`) against the dense adjacency, and the synthetic cases of
ops/bp_cases.py (several beads in a rotamer slot, invalid slots, a replica
without any edge, a residue without a neighbour) against the JAX package.

The compact passes are integer bookkeeping and gathers, so everything is
compared exactly.  The cases go through `_bp_solve` + `bethe_free_energy`
(upside_md_tpu/nodes/rotamer.py) in float64 at BP tol 1e-6: sweep counts
equal, beliefs rel 1e-6, F and the gradients rel 1e-4, as in
tests/test_torch_bp.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upside_md_tpu.nodes.rotamer import _bp_solve, bethe_free_energy
from upside_md_torch.ops import bp_cases
from upside_md_torch.ops import bp_pairs as bp
from upside_md_torch.ops import bp_planes as bpp

SIZES = [2, 33, 76, 128]            # 128 is the kernels' cap
DAMPING, MAX_ITER, TOL, CHUNK = 0.1, 1000, 1e-6, 2


def adjacency(R, seed=0, n_rep=3):
    """Symmetric (n_rep, R, R) bool without diagonal: replica 1 has no
    edge at all, residue 1 no neighbour in any replica (R > 2)."""
    rng = np.random.default_rng(seed)
    adj = np.triu(rng.random((n_rep, R, R)) < (0.5 if R < 10 else 0.12), 1)
    adj = adj | adj.transpose(0, 2, 1)
    adj[1] = False
    if R > 2:
        adj[:, 1] = adj[:, :, 1] = False
    else:
        adj[0] = ~np.eye(2, dtype=bool)
    return adj


@pytest.mark.parametrize("R", SIZES)
def test_compact_edges_match_dense_adjacency(R):
    adj = adjacency(R)
    count, edges, rev, pair = bp.compact_edges(torch.tensor(adj))
    assert edges.shape == (3, R * (R - 1)) and edges.dtype == torch.int32
    assert count.tolist() == adj.sum((1, 2)).tolist()
    assert count[1] == 0 and count[0] > 0
    for r in range(3):
        n = int(count[r])
        want = np.flatnonzero(adj[r].ravel())         # row-major (i, j)
        e = edges[r, :n].numpy()
        np.testing.assert_array_equal(e, want)
        i, j = e // R, e % R
        assert not np.any(i == 1) or R == 2
        # the reverse of (i, j) is (j, i), and reversing twice is identity
        np.testing.assert_array_equal(e[rev[r, :n].numpy()], j * R + i)
        np.testing.assert_array_equal(rev[r, rev[r, :n].long()].numpy(),
                                      np.arange(n))
        # both directions share the block of the pair (min, max), and the
        # blocks number the pairs i < j in row-major order
        upper = want[want // R < want % R]
        np.testing.assert_array_equal(
            upper[pair[r, :n].numpy()],
            np.minimum(i, j) * R + np.maximum(i, j))
        assert sorted(set(pair[r, :n].tolist())) == list(range(n // 2))
        for t in (edges, rev, pair):
            assert (t[r, n:] == -1).all()
        # CSR: each residue's edges are one contiguous run
        assert np.all(np.diff(i) >= 0)


def test_compact_edges_ignore_the_diagonal():
    adj = torch.tensor(adjacency(33))
    with_diag = adj | torch.eye(33, dtype=torch.bool)
    for a, b in zip(bp.compact_edges(adj), bp.compact_edges(with_diag)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("R", SIZES)
def test_message_round_trips(R):
    adj = torch.tensor(adjacency(R, seed=1))
    _, edges, _, _ = bp.compact_edges(adj)
    gen = torch.Generator().manual_seed(R)
    eb = torch.rand((3, R, R, 6), generator=gen, dtype=torch.float64)
    msg = bp.compact_messages(eb, edges)
    dense = bp.dense_messages(msg, edges, R)
    # dense -> compact -> dense keeps the edges and is 1.0 elsewhere
    assert torch.equal(dense, torch.where(adj[..., None], eb,
                                          torch.ones_like(eb)))
    # compact -> dense -> compact is the identity
    assert torch.equal(bp.compact_messages(dense, edges), msg)
    assert (dense[1] == 1.0).all()


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("R", SIZES)
def test_factor_round_trips(R, shared):
    """Factor blocks per undirected pair (K2) and per directed edge (K6):
    compact -> dense gives P on adjacent i < j and 0 elsewhere, and dense
    -> compact gives the blocks back."""
    adj = torch.tensor(adjacency(R, seed=2))
    count, edges, _, pair = bp.compact_edges(adj)
    pair = pair if shared else None
    gen = torch.Generator().manual_seed(R)
    P = torch.rand((3, R, R, 6, 6), generator=gen, dtype=torch.float64)
    blocks = bp.compact_factors(P, edges, pair)
    assert blocks.shape == (3, R * (R - 1) // (2 if shared else 1), 36)
    dense = bp.dense_pair_gradient(blocks, edges, pair, R)
    upper = torch.triu(adj, 1)[..., None, None]
    assert torch.equal(dense, torch.where(upper, P, torch.zeros_like(P)))
    again = bp.compact_factors(dense, edges, pair)
    if shared:
        assert torch.equal(again, blocks)
    else:                       # the blocks of edges i > j are dropped
        keep = ((edges >= 0) & (edges // R < edges % R))[..., None]
        assert torch.equal(again, torch.where(keep, blocks,
                                              torch.zeros_like(blocks)))
    for r in range(3):
        n = int(count[r]) // 2 if shared else int(count[r])
        assert (blocks[r, n:] == 0).all()


@pytest.mark.parametrize("n_edges,n_blocks,smem,want", [
    (0, 0, 0, 0),                        # a replica without any edge
    (670, 335, 218880, 0),               # ubiquitin
    (1000, 1000, 218880, 0),             # RNase A
    (1400, 1400, 218880, 1),             # 40% more edges than RNase A
    (5700, 2850, 218880, 2),             # every pair of 76 residues
    (16256, 16256, 218880, 2),           # every pair of 128 residues
    (100, 50, 16 * 50 + 48 * 100 + 144 * 50, 0),
    (100, 50, 16 * 50 + 48 * 100 + 144 * 50 - 1, 1),
    (100, 50, 16 * 50 + 48 * 100 - 1, 2),
])
def test_solve_layout_rule(n_edges, n_blocks, smem, want):
    assert bp.solve_layout(n_edges, n_blocks, smem) == want
    assert bp.SOLVE_SMEM_BYTES == 218880 <= 232448 - 13508


@pytest.mark.parametrize("shared", [True, False])
def test_scratch_shapes(shared):
    """The views of the two scratch buffers tile them without overlap."""
    sc = bp.BPScratch(2, 76, shared, "cpu")
    cap = 76 * 75
    assert sc.edges.shape == sc.reverse.shape == sc.pair_index.shape \
        == (2, cap)
    assert sc.factors.shape == (2, cap // 2 if shared else cap, 36)
    assert sc.messages.shape == (2, 2, cap, 6)
    assert sc.adjw.shape == (2, 76 * 4) and sc.row_start.shape == (2, 77)
    sc.ibuf.zero_()
    sc.fbuf.zero_()
    names = ("adjw", "cand", "counts", "row_start", "edges", "reverse",
             "pair_index", "upair")
    for k, name in enumerate(names):
        getattr(sc, name).fill_(k + 1)
    sc.factors.fill_(1.0)
    sc.messages.fill_(2.0)
    assert all((getattr(sc, name) == k + 1).all()
               for k, name in enumerate(names))
    assert sc.ibuf.count_nonzero() == sc.ibuf.numel()
    assert (sc.factors == 1.0).all() and (sc.messages == 2.0).all()
    assert sc.fbuf.count_nonzero() == sc.fbuf.numel() - 2 * bp.N_FSUM


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _jax_solve(E1, E2, adj, valid):
    """One replica: (F, dF/dE1, dF/dE2 (R, R, 6, 6), nb, sweeps)."""
    vj, aj = jnp.asarray(valid), jnp.asarray(adj)

    def F(E1_, E2_):
        off = jnp.min(jnp.where(vj, E1_, jnp.inf), -1)
        pr = jnp.where(vj, jnp.exp(off[:, None] - E1_), 0.0)
        P = jnp.exp(-E2_)
        nb, eb, it = _bp_solve(jax.lax.stop_gradient(pr),
                               jax.lax.stop_gradient(P), aj, vj, DAMPING,
                               MAX_ITER, TOL, CHUNK, return_iters=True)
        return bethe_free_energy(E1_, off, P, aj, vj, nb, eb), (nb, it)

    (f, (nb, it)), (g1, g2) = jax.value_and_grad(
        F, argnums=(0, 1), has_aux=True)(jnp.asarray(E1), jnp.asarray(E2))
    return float(f), np.asarray(g1), np.asarray(g2), np.asarray(nb), int(it)


@pytest.mark.parametrize("m_slot", [1, 3])
def test_pairs_case_matches_bp_solve(m_slot):
    """K2's plain version on a mixed batch with `m_slot` beads in a slot:
    the slot scatter against a one-hot product, then each replica against
    `_bp_solve` on the port's adjacency."""
    E1, E, res, rot, valid, n2p = bp_cases.pairs_case(
        1, n_res=9, m_slot=m_slot, **bp_cases.MIXED)
    st = bp.make_statics(res, rot, valid, n2p, DAMPING, MAX_ITER, TOL, CHUNK,
                         "cpu")
    assert st.slot_beads.shape[1] == m_slot and not valid.all()
    e1 = torch.tensor(E1, requires_grad=True)
    ep = torch.tensor(E, requires_grad=True)
    R, n = st.n_res, len(res)
    oh = np.zeros((n, R * 6))
    oh[np.arange(n), res * 6 + rot] = 1.0
    U = np.einsum("ps,bpq,qt->bst", oh, E[:, :n, :n], oh) \
        .reshape(-1, R, 6, R, 6).transpose(0, 1, 3, 2, 4)
    E2 = U + U.transpose(0, 2, 1, 4, 3)
    assert _rel(bp.scatter_pairs(st, ep.detach()).numpy(), E2) < 1e-12
    adj = (E2 != 0).any((-1, -2)) & ~np.eye(R, dtype=bool)
    assert not adj[2].any() and not adj[:, 3].any() and adj[0].any()

    F, nb, eb, dev, it = bp.bp_bethe_pairs(st, e1, ep)
    g1, gE = torch.autograd.grad(F.sum(), (e1, ep))
    assert len(set(it.tolist())) > 1
    for r in range(E1.shape[0]):
        fj, g1j, g2j, nbj, itj = _jax_solve(E1[r], E2[r], adj[r], valid)
        assert int(it[r]) == itj
        assert _rel(nb[r].numpy(), nbj) < 1e-6
        assert abs(F[r].item() - fj) <= 1e-4 * max(1.0, abs(fj))
        assert _rel(g1[r].numpy(), g1j) < 1e-4
        # dF/dE_pair[p, q] = dF/dE2 at the slots of p and q, both orders
        g2 = (g2j + g2j.transpose(1, 0, 3, 2)).transpose(0, 2, 1, 3) \
            .reshape(R * 6, R * 6)
        s = res * 6 + rot
        assert np.abs(gE[r].numpy()[:n, :n] - g2[s[:, None], s[None, :]]) \
            .max() <= 1e-4 * max(np.abs(g2).max(), 1e-30)


def test_planes_case_matches_bp_solve():
    """K6's plain version on a mixed batch, each replica with its own
    adjacency (one empty, one residue without a neighbour)."""
    E1, E2p, adj, res, rot, valid = bp_cases.planes_case(
        1, n_res=14, density=0.25, **bp_cases.MIXED)
    st = bp.make_statics(res, rot, valid, 128, DAMPING, MAX_ITER, TOL, CHUNK,
                         "cpu")
    R = st.n_res
    e1 = torch.tensor(E1, requires_grad=True)
    e2 = torch.tensor(E2p, requires_grad=True)
    F, nb, eb, dev, it = bpp.bp_bethe_planes(st, e1, e2, torch.tensor(adj))
    g1, g2 = torch.autograd.grad(F.sum(), (e1, e2))
    assert not adj[2].any() and not adj[:, 3].any()
    assert len(set(it.tolist())) > 1 and (eb[2] == 1.0).all()
    for r in range(E1.shape[0]):
        E2 = E2p[r].reshape(6, 6, R, R).transpose(2, 3, 0, 1)
        fj, g1j, g2j, nbj, itj = _jax_solve(E1[r], E2, adj[r], valid)
        assert int(it[r]) == itj
        assert _rel(nb[r].numpy(), nbj) < 1e-6
        assert abs(F[r].item() - fj) <= 1e-4 * max(1.0, abs(fj))
        assert _rel(g1[r].numpy(), g1j) < 1e-4
        want = g2j.transpose(2, 3, 0, 1).reshape(36, R, R)
        assert np.abs(g2[r].numpy() - want).max() \
            <= 1e-4 * max(np.abs(want).max(), 1e-30)


def test_planes_plain_symmetrises_adjacency():
    """K6's plain version joins residues where either adj[i, j] or
    adj[j, i] is set, as its kernel does: an adjacency given on one side of
    the diagonal only solves the same problem as the symmetric one."""
    E1, E2p, adj, res, rot, valid = bp_cases.planes_case(
        1, n_res=14, density=0.25, **bp_cases.MIXED)
    st = bp.make_statics(res, rot, valid, 128, DAMPING, MAX_ITER, TOL, CHUNK,
                         "cpu")
    a = torch.tensor(adj)
    one_sided = a.clone()
    one_sided[0] = torch.triu(a[0])
    one_sided[1] = torch.tril(a[1])
    assert not torch.equal(one_sided, a)
    P = bpp.boltzmann_planes(torch.tensor(E2p), st.valid)
    got = bpp.bp_bethe_planes_plain(st, torch.tensor(E1), P, one_sided)
    want = bpp.bp_bethe_planes_plain(st, torch.tensor(E1), P, a)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert want[2].count_nonzero() > 0


@pytest.mark.parametrize("kernel,case", [
    ("K2", c) for c in bp_cases.PAIRS_CASES] + [
    ("K6", c) for c in bp_cases.PLANES_CASES])
def test_case_reaches_its_layout(kernel, case):
    """The edge counts of each synthetic case put its replicas with edges
    into the solve layout `bp_cases.CASE_LAYOUT` names (0 for the rest),
    by the rule of size `solve_layout` states; together the cases reach
    all three layouts."""
    if kernel == "K2":
        _, E, res, rot, valid, n2p = bp_cases.pairs_case(
            **bp_cases.MIXED, **bp_cases.PAIRS_CASES[case])
        st = bp.make_statics(res, rot, valid, n2p, *bp_cases.BP_SETTINGS,
                             "cpu")
        E2 = bp.scatter_pairs(st, torch.tensor(E, dtype=torch.float32))
        adj = (E2 != 0).any(-1).any(-1) \
            & ~torch.eye(st.n_res, dtype=torch.bool)
    else:
        adj = torch.tensor(bp_cases.planes_case(
            **bp_cases.MIXED, **bp_cases.PLANES_CASES[case])[2])
    count = bp.compact_edges(adj)[0].tolist()
    layouts = [bp.solve_layout(n, n // 2 if kernel == "K2" else n)
               for n in count]
    want = bp_cases.CASE_LAYOUT.get(case, 0)
    assert count[bp_cases.MIXED["empty_replica"]] == 0
    assert [lay for n, lay in zip(count, layouts) if n] == [want] * 3
    assert set(bp_cases.CASE_LAYOUT.values()) == {1, 2}
