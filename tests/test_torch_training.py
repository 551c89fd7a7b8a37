"""The port's training module (upside_md_torch/training.py) against the
JAX package's, on a trp-cage bundle built here without the environment
chain (the training slice's graph: the fused block without its env band,
differentiated through the plain K3 and the table cotangents), float64 on
the CPU, positions perturbed from a numpy seed.

* three steps of `fit_packed` of the symmetric rotamer table under the
  energy-gap loss, from the same parameters (`params_from_jax`): the
  port's torch.optim.Adam against the JAX package's optax.adam, loss
  history and final table at rel 1e-4;
* the rotamer-state restricted system and the node marginals against
  `rotamer_node_marginals`: beliefs at abs 1e-4 (BP stops at the config's
  tol 1e-3 in both, on the same schedule);
* the constrained packings against the JAX ones at 1e-12;
* `energy_match_loss` and `contrastive_divergence_loss` with their
  parameter gradients, `multi_system_gradient` and `fit` against the
  port's own param_deriv;
* the rotamer table's gradient through residue pairs whose energies all
  vanish (K2 leaves them out of its graph) against JAX at rel 1e-4.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_nodes import jax_params64, jax_specs
from upside_md_tpu import training as jt
from upside_md_tpu.system import System as JSystem
from upside_md_torch import training as tt
from upside_md_torch.config import bundle
from upside_md_torch.convert import params_from_jax, params_to_numpy
from upside_md_torch.system import System

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def trp(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "export_torch_bundle",
        os.path.join(ROOT, "tools", "export_torch_bundle.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = str(tmp_path_factory.mktemp("bundles"))
    path = tool.build_bundle("trp_cage_noenv_synth", out, out)
    records, pos = bundle.load(path)
    js = JSystem(len(pos), jax_specs(records))
    jp = jax_params64(js)
    ts = System(len(pos), records, "cpu", torch.float64)
    assert ts.pair_fusion is not None and ts.pair_fusion.env is None
    rng = np.random.default_rng(4)
    P = pos.astype(np.float64) + 0.05 * rng.normal(size=pos.shape)
    P2 = pos.astype(np.float64) + 0.05 * rng.normal(size=pos.shape)
    states = tt.rotamer_node_marginals(
        ts, torch.tensor(P)).argmax(-1).numpy()
    return dict(js=js, jp=jp, ts=ts, P=P, P2=P2, states=states, path=path)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def test_fit_packed_matches_jax(trp):
    js, jp, ts, P, states = (trp[k] for k in ("js", "jp", "ts", "P",
                                              "states"))
    fixed_j = jt.rotamer_state_restricted_system(js, states)
    fixed_t = tt.rotamer_state_restricted_system(ts, states)
    Pj, Pt = jnp.asarray(P), torch.tensor(P)
    out_j, hist_j = jt.fit_packed(
        js, lambda p: jt.energy_gap_loss(fixed_j, js, Pj)(p, {}), jp,
        ["rotamer"], n_steps=3, learning_rate=0.03)
    params = params_from_jax(jp, "cpu", torch.float64)
    out_t, hist_t = tt.fit_packed(
        ts, lambda p: tt.energy_gap_loss(fixed_t, ts, Pt)(p, {}), params,
        ["rotamer"], n_steps=3, learning_rate=0.03)
    assert hist_j[0] > 0 and hist_j[-1] < hist_j[0]
    assert _rel(hist_t, hist_j) < 1e-4
    t_t = params_to_numpy(out_t)["rotamer"]["interaction_param"]
    t_j = np.asarray(out_j["rotamer"]["interaction_param"])
    assert _rel(t_t, t_j) < 1e-4
    # symmetric packing: ang2 is ang1 transposed, the distance parts are
    # symmetric in the two types
    np.testing.assert_array_equal(t_t[..., 8:16],
                                  np.swapaxes(t_t[..., :8], 0, 1))
    np.testing.assert_allclose(t_t[..., 16:], np.swapaxes(t_t[..., 16:], 0, 1),
                               rtol=0, atol=1e-12)
    assert not np.allclose(t_t, np.asarray(jp["rotamer"]["interaction_param"]))


def test_restricted_system_and_marginals_match_jax(trp):
    js, jp, ts, P, states = (trp[k] for k in ("js", "jp", "ts", "P",
                                              "states"))
    Pt = torch.tensor(P)
    nb_j = jax.jit(lambda x: jt.rotamer_node_marginals(js, x, jp))(
        jnp.asarray(P))
    nb_t = tt.rotamer_node_marginals(ts, Pt)
    assert np.abs(nb_t.numpy() - np.asarray(nb_j)).max() < 1e-4

    fixed = tt.rotamer_state_restricted_system(ts, states)
    assert fixed.params is ts.params
    nb = tt.rotamer_node_marginals(fixed, Pt).numpy()
    np.testing.assert_array_equal(nb.argmax(-1), states)
    assert nb.max(-1).min() > 0.999
    assert fixed.energy(Pt).item() >= ts.energy(Pt).item() - 1e-3
    n_rot = np.asarray(ts.by_name["rotamer"].consts["n_rot_per_res"])
    bad = states.copy()
    bad[np.argmax(n_rot)] = 6
    with pytest.raises(ValueError, match="rotamer count"):
        tt.rotamer_state_restricted_system(ts, bad)


@pytest.mark.parametrize("symmetric", [True, False])
def test_packing_matches_jax(symmetric):
    rng = np.random.default_rng(7)
    n, ka, k = 5, 8, 9
    pj = jt.QuadsplinePacking(n, n, ka, k, symmetric)
    pt = tt.QuadsplinePacking(n, n, ka, k, symmetric)
    theta = rng.normal(size=pj.n_free)
    tab_j = np.asarray(pj.unpack(jnp.asarray(theta)))
    tab_t = pt.unpack(torch.tensor(theta)).numpy()
    np.testing.assert_allclose(tab_t, tab_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(pt.pack(tab_t), pj.pack(tab_j), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(pt.unpack(torch.tensor(pt.pack(tab_t)))
                               .numpy(), tab_t, atol=1e-6)


def test_losses_gradients_and_fit(trp):
    ts, P, P2 = trp["ts"], trp["P"], trp["P2"]
    batch = torch.tensor(np.stack([P, P2]))
    params = ts.params
    tr, fr = tt.select_trainable(params, ["rotamer", "hbond_energy"])
    assert set(tt.merge_params(tr, fr)) == set(params)

    def grad_of(loss):
        leaves = {n: {k: v.detach().requires_grad_(True)
                      for k, v in tr[n].items()} for n in tr}
        value = loss(leaves, fr)
        g = torch.autograd.grad(value, leaves["rotamer"]["interaction_param"])
        return value.item(), g[0]

    # energy match: d/dtheta mean (e - t)^2 = mean 2 (e - t) dE/dtheta
    e = ts.energy(batch).detach()
    target = e + torch.tensor([0.5, -0.25], dtype=e.dtype)
    value, g = grad_of(tt.energy_match_loss(ts, batch, target))
    d = [ts.param_deriv(batch[i:i + 1], "rotamer")["interaction_param"]
         for i in range(2)]
    want = sum(2 * (e[i] - target[i]) * d[i] for i in range(2)) / 2
    assert abs(value - 0.5 * (0.25 + 0.0625)) < 1e-12
    assert _rel(g, want) < 1e-9

    # contrastive divergence: weights softmax(-E) over the ensemble
    value, g = grad_of(tt.contrastive_divergence_loss(ts, batch[0], batch))
    w = torch.softmax(-e, 0)
    assert abs(value - (e[0] + torch.logsumexp(-e, 0) - np.log(2)).item()) \
        < 1e-9
    assert _rel(g, d[0] - w[0] * d[0] - w[1] * d[1]) < 1e-9

    total, grads = tt.multi_system_gradient(
        [(ts, batch[0]), (ts, batch[1])], params)
    assert abs(total - e.sum().item()) < 1e-9
    assert _rel(grads["rotamer"]["interaction_param"], d[0] + d[1]) < 1e-9

    tr1, fr1 = tt.select_trainable(params, ["hbond_energy"])
    fitted, hist = tt.fit(tt.energy_match_loss(ts, batch, target), tr1,
                          fr1, n_steps=3, learning_rate=0.05)
    assert hist[-1] < hist[0]
    assert fitted["hbond_energy"]["protein_hbond_energy"].item() != \
        params["hbond_energy"]["protein_hbond_energy"].item()


def test_param_deriv_through_identity_edges(trp):
    """Residue pairs whose bead-pair energies all vanish are left out of
    K2's graph; the rotamer table's gradient still needs dF/dE_pair there
    (the identity edge's pair belief), as the JAX package's XLA path gives
    it.  Zero the distance profiles of every type pair involving the upper
    half of the types, so that many in-cutoff residue pairs carry only
    exact zeros, and compare the table gradient with JAX at rel 1e-4."""
    records, pos = bundle.load(trp["path"])
    for r in records:
        if r.type_name == "rotamer":
            t = np.array(r.params["interaction_param"])
            t[10:, :, 16:] = 0.0
            t[:, 10:, 16:] = 0.0
            r.params["interaction_param"] = t
    js = JSystem(len(pos), jax_specs(records))
    jp = jax_params64(js)
    ts = System(len(pos), records, "cpu", torch.float64)
    P = trp["P"]
    want = jax.jit(jax.grad(lambda p: js.energy(jnp.asarray(P), p)))(jp)[
        "rotamer"]["interaction_param"]
    got = ts.param_deriv(torch.tensor(P)[None], "rotamer")[
        "interaction_param"].numpy()
    want = np.asarray(want)
    assert np.abs(want[10:, :, 16:]).max() > 0
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_params_from_jax_device_default():
    """`params_from_jax` puts the tensors on the card by default, as
    `System` and `Upside` do, and raises without one; on request it keeps
    them on the CPU, floats in the asked dtype and integers as they are."""
    jp = {"node": {"table": np.arange(6.0).reshape(2, 3),
                   "index": np.arange(4)}}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            params_from_jax(jp)
    else:
        assert params_from_jax(jp)["node"]["table"].is_cuda
    p = params_from_jax(jp, "cpu", torch.float64)
    assert p["node"]["table"].dtype == torch.float64
    assert p["node"]["index"].dtype == torch.int64
    np.testing.assert_array_equal(params_to_numpy(p)["node"]["table"],
                                  jp["node"]["table"])
