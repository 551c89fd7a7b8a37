"""The port past 128 rotamer residues against the JAX package, on the
164-residue T4 lysozyme bundle (770 sidechain beads: the unfused path, K4
for both coverage nodes, K5 for the rotamer grid, each on its plain
version here on the CPU, and BP on residue planes by the port of the XLA
`_bp_solve`, upside_md_tpu/nodes/rotamer.py:463-483).

* energy, per-term energies and forces of the whole graph: port vs the JAX
  System on the CPU, both in float64: rel 1e-4, forces as RMS relative
  error; the rotamer took the planes branch with R = 164;
* one 3-stage Verlet round with the BP cache threaded through the stages:
  positions and momenta at rel 1e-4, the threaded beliefs at 1e-4;
* the residue-plane solve is chosen by R alone, as `_use_pallas_bp`
  (rotamer.py:271-275) chooses it: K6 on a CUDA tensor up to 128
  residues, the plain `_bp_solve` port above them, on the CPU and when
  asked; K6 itself refuses more than 128 residues;
* the bundle's sizes: 164 residues, 770 beads, under 7.5 MB.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_nodes import load_pair
from upside_md_tpu.md.integrator import integration_cycle as jax_cycle
from upside_md_torch import DATA_DIR
from upside_md_torch.md.integrator import integration_cycle
from upside_md_torch.nodes import rotamer as trot
from upside_md_torch.ops import bp_planes as bpp
from upside_md_torch.ops.bp_pairs import MAX_RES, make_statics

T4 = os.path.join(DATA_DIR, "t4_lysozyme_full_synth.npz")


@pytest.fixture(scope="module")
def t4():
    records, pos, js, jp, ts = load_pair(T4)
    rng = np.random.default_rng(19)
    P = pos.astype(np.float64) + 0.05 * rng.normal(size=pos.shape)
    mom = rng.normal(size=pos.shape)
    return dict(records=records, js=js, jp=jp, ts=ts, P=P, mom=mom)


@pytest.fixture
def planes_calls(monkeypatch):
    """The residue counts of the rotamer node's residue-plane solves."""
    calls = []
    real = trot.bp_bethe_planes

    def spy(st, *args, **kw):
        calls.append(st.n_res)
        return real(st, *args, **kw)

    monkeypatch.setattr(trot, "bp_bethe_planes", spy)
    return calls


def _rms_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2))


def test_large_energy_terms_and_forces_match_jax(t4, planes_calls):
    js, jp, ts, P = t4["js"], t4["jp"], t4["ts"], t4["P"]
    rot = [s for s in t4["records"] if s.type_name == "rotamer"][0]
    assert (rot.consts["n_res"], len(rot.consts["index"])) == (164, 770)

    @jax.jit
    def jax_eval(x):
        def total(y):
            e, _, per = js.evaluate(y, jp)
            return e, per
        (e, per), g = jax.value_and_grad(total, has_aux=True)(x)
        return e, per, g

    e_j, per_j, g_j = jax_eval(jnp.asarray(P))
    x = torch.tensor(P[None], requires_grad=True)
    total, _, per_t, _ = ts.evaluate(x)
    (g_t,) = torch.autograd.grad(total.sum(), x)
    assert ts.pair_fusion is None
    assert planes_calls == [164]
    assert set(per_t) == set(per_j)
    for name, v in per_t.items():
        assert abs(v.item() - float(per_j[name])) <= \
            1e-4 * max(1.0, abs(float(per_j[name]))), name
    assert abs(total.item() - float(e_j)) <= 1e-4 * abs(float(e_j))
    assert _rms_rel(g_t[0].numpy(), g_j) < 1e-4


def test_large_verlet_round_with_cache_matches_jax(t4, planes_calls):
    js, jp, ts, P, mom = t4["js"], t4["jp"], t4["ts"], t4["P"], t4["mom"]
    dt = 0.009

    def jax_deriv(p, stage, cache):
        return jax.grad(lambda q: js.energy_and_cache(q, jp, cache=cache),
                        has_aux=True)(p)

    pos_j, mom_j, cache_j = jax.jit(
        lambda p, m, c: jax_cycle(jax_deriv, p, m, dt, cache=c))(
        jnp.asarray(P), jnp.asarray(mom), js.init_cache())

    def deriv(p, stage, cache):
        g, _, cache = ts.deriv(p, cache)
        return g, cache

    pos_t, mom_t, cache_t = integration_cycle(
        deriv, torch.tensor(P[None]), torch.tensor(mom[None]), dt,
        ts.init_cache(1))
    assert planes_calls == [164] * 3
    assert np.abs(pos_t[0].numpy() - np.asarray(pos_j)).max() \
        <= 1e-4 * np.abs(np.asarray(pos_j)).max()
    assert _rms_rel(mom_t[0].numpy(), mom_j) < 1e-4
    nb_t = cache_t["rotamer"]["nb"][0].numpy()
    assert nb_t.shape == (164, 6)
    assert np.abs(nb_t - np.asarray(cache_j["rotamer"][0])).max() < 1e-4


@pytest.mark.parametrize("n_res", [2, 127, MAX_RES, MAX_RES + 1, 164, 238])
def test_planes_solver_is_chosen_by_residue_count(n_res):
    kernel = n_res <= MAX_RES
    assert bpp.planes_solver(n_res, True) is \
        (bpp.k6 if kernel else bpp.bp_bethe_planes_plain)
    assert bpp.planes_solver(n_res, False) is bpp.bp_bethe_planes_plain
    assert bpp.planes_solver(n_res, True, plain=True) is \
        bpp.bp_bethe_planes_plain


def test_k6_refuses_more_than_128_residues():
    R = MAX_RES + 1
    st = make_statics(np.repeat(np.arange(R), 1), np.zeros(R, int),
                      np.ones((R, 6), bool), 256, 0.1, 100, 1e-3, 2, "cpu")
    with pytest.raises(ValueError, match="2 to 128 residues"):
        bpp.bp_planes_kernel(st, torch.zeros(1, R, 6),
                             torch.ones(1, 36, R, R),
                             torch.zeros(1, R, R, dtype=torch.bool))


def test_bundle_size():
    assert os.path.getsize(T4) < 7.5e6
