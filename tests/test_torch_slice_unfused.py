"""The port's unfused path as a whole against the JAX package, on the
124-residue RNase A bundle (543 sidechain beads: above the fused block's
512-bead cap, so the coverage nodes run K4, the rotamer node builds its
grid with K5 and solves BP on residue planes with K6, each on its plain
version here on the CPU).

* energy, per-term energies and forces of the whole graph: port vs the JAX
  System on the CPU (XLA path: `pair_coverage`, `assemble_rotamer_energies`
  and `_bp_solve`), both in float64: rel 1e-4, forces as RMS relative
  error; the fusion plan is None and the rotamer took the planes branch;
* one 3-stage Verlet round with the BP cache threaded through the stages:
  positions and momenta at rel 1e-4, the threaded beliefs at 1e-4;
* `System` defaults to the card and raises without one.
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
from upside_md_torch.system import System

RNASE = os.path.join(DATA_DIR, "rnase_a_full_synth.npz")


@pytest.fixture(scope="module")
def rnase():
    records, pos, js, jp, ts = load_pair(RNASE)
    rng = np.random.default_rng(17)
    P = pos.astype(np.float64) + 0.05 * rng.normal(size=pos.shape)
    mom = rng.normal(size=pos.shape)
    return dict(records=records, js=js, jp=jp, ts=ts, P=P, mom=mom)


@pytest.fixture
def planes_calls(monkeypatch):
    """Counts the rotamer node's calls of the residue-plane solver."""
    calls = []
    real = trot.bp_bethe_planes

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(trot, "bp_bethe_planes", spy)
    return calls


def _rms_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2))


def test_unfused_energy_terms_and_forces_match_jax(rnase, planes_calls):
    js, jp, ts, P = rnase["js"], rnase["jp"], rnase["ts"], rnase["P"]
    rot = [s for s in rnase["records"] if s.type_name == "rotamer"][0]
    assert len(rot.consts["index"]) > 512 and rot.consts["n_res"] <= 128

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
    assert len(planes_calls) == 1
    assert set(per_t) == set(per_j)
    for name, v in per_t.items():
        assert abs(v.item() - float(per_j[name])) <= \
            1e-4 * max(1.0, abs(float(per_j[name]))), name
    assert abs(total.item() - float(e_j)) <= 1e-4 * abs(float(e_j))
    assert _rms_rel(g_t[0].numpy(), g_j) < 1e-4


def test_unfused_verlet_round_with_cache_matches_jax(rnase, planes_calls):
    js, jp, ts, P, mom = rnase["js"], rnase["jp"], rnase["ts"], \
        rnase["P"], rnase["mom"]
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
    assert len(planes_calls) == 3
    assert np.abs(pos_t[0].numpy() - np.asarray(pos_j)).max() \
        <= 1e-4 * np.abs(np.asarray(pos_j)).max()
    assert _rms_rel(mom_t[0].numpy(), mom_j) < 1e-4
    nb_t = cache_t["rotamer"]["nb"][0].numpy()
    assert np.abs(nb_t - np.asarray(cache_j["rotamer"][0])).max() < 1e-4


def test_system_defaults_to_the_card(rnase):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        System(len(rnase["P"]), rnase["records"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        System.from_bundle(RNASE)
