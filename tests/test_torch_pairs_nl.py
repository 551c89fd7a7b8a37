"""The port's fixed-K neighbour list against the JAX package.

* `neighbor_list`, `quadspline_coverage_nl` and `scatter_rows`
  (upside_md_torch/ops/pairs.py) against upside_md_tpu/ops/pairs.py:63-131
  in float64, 200 row sites by 260 column beads over two replicas, at K =
  48 (rows overflow: the farthest partners are dropped, the same ones in
  both) and K = 256 (no row overflows): the kept partners, the values on
  the dense grid and the gradients in positions, directions and table,
  atol 1e-8 as tests/test_neighbor_list.py;
* the neighbour-list branches of the rotamer grid and of both coverage
  nodes on the trp-cage bundle, the thresholds lowered in both packages
  (and the widths too, so that rows overflow), the port's fused block off
  as the JAX package's is on the CPU: whole energy and forces at rel 1e-6
  in float64;
* a stacked table on those branches runs once a slot (`per_slot`): each
  slot equals the system evaluated alone under its own table.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import upside_md_tpu.nodes.hbond as jhb
import upside_md_tpu.nodes.rotamer as jrot
import upside_md_torch.nodes.hbond as thb
import upside_md_torch.nodes.rotamer as trot
import upside_md_torch.system as tsys
from test_torch_nodes import TRP, load_pair
from upside_md_tpu.ops import pairs as jpairs
from upside_md_torch.ops import pairs as tpairs

B, N1, N2, N_TYPE = 2, 200, 260, 3
KA, K = 8, 9
CUTOFF2 = (K - 2 - 1e-6) ** 2


@pytest.fixture(scope="module")
def sites():
    rng = np.random.default_rng(23)

    def unit(shape):
        d = rng.normal(size=shape)
        return d / np.linalg.norm(d, axis=-1, keepdims=True)

    return dict(
        pos1=4.0 * rng.normal(size=(B, N1, 3)), dir1=unit((B, N1, 3)),
        pos2=4.0 * rng.normal(size=(B, N2, 3)), dir2=unit((B, N2, 3)),
        t1=rng.integers(0, N_TYPE, N1), t2=rng.integers(0, N_TYPE, N2),
        table=rng.normal(size=(N_TYPE, N_TYPE, 2 * KA + 2 * K)),
        base=np.abs(np.arange(N1)[:, None] - np.arange(N2)[None, :]) > 2,
        g=rng.normal(size=(B, N1, N2)))


@pytest.mark.parametrize("width", [48, 256])
def test_neighbor_list_keeps_the_same_partners(sites, width):
    s = sites
    idx, mask = tpairs.neighbor_list(
        torch.tensor(s["pos1"]), torch.tensor(s["pos2"]), CUTOFF2,
        torch.tensor(s["base"]), width)
    assert idx.shape == mask.shape == (B, N1, width)
    counts = tpairs.partner_counts(
        torch.tensor(s["pos1"]), torch.tensor(s["pos2"]), CUTOFF2,
        torch.tensor(s["base"]))
    # the list holds min(partners, K) of each row
    assert torch.equal(mask.sum(-1), counts.clamp(max=width))
    if width == 48:
        assert int(counts.max()) > width        # rows overflow
    else:
        assert int(counts.max()) < width        # none does
    for b in range(B):
        j_idx, j_mask = jpairs.neighbor_list(
            jnp.asarray(s["pos1"][b]), jnp.asarray(s["pos2"][b]), CUTOFF2,
            jnp.asarray(s["base"]), width)
        j_idx, j_mask = np.asarray(j_idx), np.asarray(j_mask)
        np.testing.assert_array_equal(mask[b].sum(-1).numpy(),
                                      j_mask.sum(-1))
        for i in range(N1):
            assert set(idx[b, i][mask[b, i]].tolist()) == \
                set(j_idx[i][j_mask[i]].tolist()), (b, i)


@pytest.mark.parametrize("width", [48, 256])
def test_coverage_nl_values_and_gradients_match_jax(sites, width):
    s = sites
    leaves = [torch.tensor(s[k], requires_grad=True)
              for k in ("table", "pos1", "dir1", "pos2", "dir2")]
    cov, idx, mask = tpairs.quadspline_coverage_nl(
        leaves[0], torch.tensor(s["t1"]), torch.tensor(s["t2"]), *leaves[1:],
        KA, K, 1.0, torch.tensor(s["base"]), width)
    dense = tpairs.scatter_rows(cov, idx, mask, N2)
    assert dense.shape == (B, N1, N2)
    got = torch.autograd.grad((dense * torch.tensor(s["g"])).sum(), leaves)

    def grid(table, p1, d1, p2, d2):
        c, i, m = jpairs.quadspline_coverage_nl(
            table, s["t1"], s["t2"], p1, d1, p2, d2, KA, K, 1.0,
            jnp.asarray(s["base"]), width)
        return jpairs.scatter_rows(c, i, m, N2)

    table_grad = np.zeros_like(s["table"])
    for b in range(B):
        args = (s["table"],) + tuple(s[k][b] for k in
                                     ("pos1", "dir1", "pos2", "dir2"))
        want = np.asarray(grid(*map(jnp.asarray, args)))
        np.testing.assert_allclose(dense[b].detach().numpy(), want,
                                   rtol=0, atol=1e-8)
        grads = jax.grad(lambda *a: jnp.sum(grid(*a) * s["g"][b]),
                         argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
        for g_t, g_j in zip(got[1:], grads[1:]):
            np.testing.assert_allclose(g_t[b].numpy(), np.asarray(g_j),
                                       rtol=0, atol=1e-8)
        table_grad += np.asarray(grads[0])
    np.testing.assert_allclose(got[0].numpy(), table_grad, rtol=0, atol=1e-8)


def test_scatter_rows_drops_the_slots_off_the_list():
    rng = np.random.default_rng(3)
    vals = rng.normal(size=(B, 5, 4))
    idx = np.stack([rng.permutation(7)[:4] for _ in range(B * 5)]) \
        .reshape(B, 5, 4)
    mask = rng.random((B, 5, 4)) < 0.6
    got = tpairs.scatter_rows(torch.tensor(vals), torch.tensor(idx),
                              torch.tensor(mask), 7).numpy()
    for b in range(B):
        want = jpairs.scatter_rows(jnp.asarray(vals[b]), jnp.asarray(idx[b]),
                                   jnp.asarray(mask[b]), 7)
        np.testing.assert_array_equal(got[b], np.asarray(want))


# ---------------------------------------------------------------------------
# the nodes' neighbour-list branches, thresholds lowered in both packages
# ---------------------------------------------------------------------------

@pytest.fixture
def nl_branches(monkeypatch):
    """Both packages take the neighbour lists on trp-cage (96 beads, 96
    coverage columns), the port without its fused block; counts the
    port's neighbour-list calls."""
    for mod in (jrot, trot):
        monkeypatch.setattr(mod, "NEIGHBOR_LIST_THRESHOLD", 64)
    for mod in (jhb, thb):
        monkeypatch.setattr(mod, "COVERAGE_NL_THRESHOLD", 64)
    monkeypatch.setattr(tsys, "plan_pair_fusion", lambda specs: None)
    calls = []
    real = tpairs.quadspline_coverage_nl

    def spy(*args, **kw):
        calls.append(args[-1])
        return real(*args, **kw)

    monkeypatch.setattr(trot, "quadspline_coverage_nl", spy)
    monkeypatch.setattr(thb, "quadspline_coverage_nl", spy)
    return calls


def _rms_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2))


@pytest.mark.parametrize("widths", [(128, 96), (24, 16)],
                         ids=["reference_widths", "overflowing_widths"])
def test_nl_branches_match_jax(nl_branches, monkeypatch, widths):
    for mod in (jrot, trot):
        monkeypatch.setattr(mod, "NEIGHBOR_K", widths[0])
    for mod in (jhb, thb):
        monkeypatch.setattr(mod, "COVERAGE_NEIGHBOR_K", widths[1])
    records, pos, js, jp, ts = load_pair(TRP)
    assert ts.pair_fusion is None
    P = pos.astype(np.float64) + 0.05 * np.random.default_rng(11).normal(
        size=pos.shape)

    @jax.jit
    def jax_eval(x):
        return jax.value_and_grad(lambda y: js.evaluate(y, jp)[0])(x)

    e_j, g_j = jax_eval(jnp.asarray(P))
    x = torch.tensor(P[None], requires_grad=True)
    total = ts.evaluate(x)[0]
    (g_t,) = torch.autograd.grad(total.sum(), x)
    # the rotamer grid at min(96, K) and both coverages
    assert sorted(nl_branches) == sorted([min(96, widths[0]), widths[1],
                                          widths[1]])
    assert abs(total.item() - float(e_j)) <= 1e-6 * abs(float(e_j))
    assert _rms_rel(g_t[0].numpy(), g_j) < 1e-6


def test_nl_branches_stacked_tables_run_once_a_slot(nl_branches):
    """A rotamer and a coverage table stacked over two replicas: each
    slot's energy and forces equal the system alone under that slot's
    tables."""
    records, pos, _, _, ts = load_pair(TRP)
    P = torch.tensor(np.stack([pos, pos + 0.03]).astype(np.float64))
    cov = next(s.name for s in ts.specs
               if s.node_type.name == "hbond_coverage")
    slots = [{**ts.params,
              "rotamer": {"interaction_param":
                          ts.params["rotamer"]["interaction_param"] * f},
              cov: {"interaction_param":
                    ts.params[cov]["interaction_param"] * f}}
             for f in (0.9, 1.1)]
    stacked = {n: {k: torch.stack([s[n][k] for s in slots])
                   if n in ("rotamer", cov) else v for k, v in leaves.items()}
               for n, leaves in ts.params.items()}
    g, e, _ = ts.deriv(P, params=stacked)
    # once a slot for the two stacked tables, once for the shared one
    assert len(nl_branches) == 2 + 2 + 1
    for i, params in enumerate(slots):
        g1, e1, _ = ts.deriv(P[i:i + 1], params=params)
        np.testing.assert_allclose(e[i].item(), e1.item(), rtol=1e-12)
        np.testing.assert_allclose(g[i].numpy(), g1[0].numpy(), rtol=0,
                                   atol=1e-10)
