"""The extras slice as a whole against the JAX package, in float64 on the
CPU at positions perturbed by a seeded 0.05 normal.

* The whole evaluation of `trp_cage_extras_synth` and of the hand-built
  graph on it (`config/extras_graph.py`), at the force-evaluation counter
  7: energy and per-term energies rel 1e-4, forces as RMS relative error
  1e-4.  The JAX side is one compile of the hand-built graph, whose
  bundle terms are the bundle's graph.
* AFM under the MD loop: two rounds of `Simulation.advance` in both
  packages on the bundle's position-only terms with a fast-moving tip,
  the port fed the JAX package's thermostat noise: positions atol 1e-6
  and AFM's energy at the counter 6 rel 1e-6, so the tip followed the
  JAX loop's 3 * round + stage + 1; an energy-only evaluation sees the
  counter 0 in both.
* The three committed bundles of the slice against a rebuild.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_nodes import jax_params64, jax_specs
from test_torch_nodes_extra import EXTRAS, graph_records
from upside_md_tpu.md import sim as jsim
from upside_md_tpu.md.thermostat import THERMOSTAT_STREAM, stream_key
from upside_md_tpu.system import System as JSystem
from upside_md_torch import DATA_DIR
from upside_md_torch.config import bundle
from upside_md_torch.md.sim import Simulation
from upside_md_torch.system import System

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_EVALS = 7


@pytest.fixture(scope="module")
def jax_whole():
    """(P, per-term energies, forces of the bundle's graph and of the
    hand-built one) from one JAX compile of the hand-built graph: the
    forces of its bundle terms are the bundle graph's."""
    records, pos = graph_records()
    names = {r.name for r in bundle.load(EXTRAS)[0]}
    js = JSystem(len(pos), jax_specs(records))
    jp = jax_params64(js)
    P = pos.astype(np.float64) \
        + 0.05 * np.random.default_rng(3).normal(size=pos.shape)

    def terms(x):
        return js.evaluate(x, jp, extra={"n_deriv_evals": N_EVALS})[2]

    def part(x, in_bundle):
        return sum(v for k, v in terms(x).items()
                   if (k in names) == in_bundle)

    t, g_b, g_x = jax.jit(lambda x: (terms(x), jax.grad(part)(x, True),
                                     jax.grad(part)(x, False)))(
        jnp.asarray(P))
    return dict(P=P, records=records, names=names,
                terms={k: float(v) for k, v in t.items()},
                forces={"bundle": np.asarray(g_b),
                        "hand_built": np.asarray(g_b) + np.asarray(g_x)})


@pytest.mark.parametrize("graph", ["bundle", "hand_built"])
def test_whole_evaluation_matches_jax(jax_whole, graph):
    """Energy, forces and per-term energies of the whole graph, the port's
    fused block (its plain version) against the JAX XLA nodes."""
    if graph == "bundle":
        records, pos = bundle.load(EXTRAS)
    else:
        records = jax_whole["records"]
    ts = System(len(jax_whole["P"]), records, device="cpu",
                dtype=torch.float64)
    x = torch.tensor(jax_whole["P"])[None]
    g_t, e_t, _ = ts.deriv(x, n_deriv_evals=N_EVALS)
    per_t = ts.evaluate(x, n_deriv_evals=N_EVALS)[2]
    want = {k: v for k, v in jax_whole["terms"].items()
            if graph == "hand_built" or k in jax_whole["names"]}
    assert set(per_t) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(per_t[k][0]), v, rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(e_t[0]), sum(want.values()), rtol=1e-4)
    g_j = jax_whole["forces"][graph]
    rms = np.sqrt(((g_t[0].numpy() - g_j) ** 2).mean() / (g_j ** 2).mean())
    assert rms < 1e-4


def test_afm_follows_the_md_counter():
    records, pos = bundle.load(EXTRAS)
    keep = {"AFM", "dist_spring", "angle_spring", "dihedral_spring",
            "tension"}
    records = [r for r in records if r.name in keep]
    afm = next(r for r in records if r.name == "AFM")
    afm.params["pulling_vel"] = np.asarray(afm.params["pulling_vel"]) * 100
    js = JSystem(len(pos), jax_specs(records))
    jp = jax_params64(js)
    ts = System(len(pos), records, device="cpu", dtype=torch.float64)
    P = pos.astype(np.float64)[None].repeat(2, 0) \
        + 0.05 * np.random.default_rng(4).normal(size=(2,) + pos.shape)
    temps, seed, rounds = np.array([0.85, 1.0]), 9, 2
    kw = dict(dt=0.009, thermostat_interval=0.027, do_recenter=False)
    jsim_ = jsim.Simulation(js, **kw)
    jstate = jsim_.initial_state(jnp.asarray(P), jp, seed=seed,
                                 temperature=temps, n_replica=2)
    jout = jsim_.advance(jstate, jp, rounds, batched=True)

    def noise(nr):
        return torch.tensor(np.stack([np.asarray(jax.random.normal(
            stream_key(seed + i, THERMOSTAT_STREAM, nr + 1), P.shape[1:],
            jnp.float64)) for i in range(2)]))

    sim = Simulation(ts, **kw)
    state = sim.initial_state(P, 2, temps)
    state.mom = torch.tensor(np.asarray(jstate.mom))
    out = sim.advance(state, rounds, noise=noise)
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(jout.pos),
                               rtol=0, atol=1e-6)
    counter = 3 * rounds
    afm_j = jax.vmap(lambda x: js.evaluate(
        x, jp, extra={"n_deriv_evals": counter})[2]["AFM"])(jout.pos)
    afm_t = ts.evaluate(out.pos, n_deriv_evals=counter)[2]["AFM"]
    np.testing.assert_allclose(afm_t.numpy(), np.asarray(afm_j), rtol=1e-6)
    # an energy-only evaluation (MC, swaps) sees the counter 0, as in JAX
    e0_j = jax.vmap(lambda x: js.energy(x, jp))(jout.pos)
    np.testing.assert_allclose(sim.energy_fn(ts.params)(out.pos).numpy(),
                               np.asarray(e0_j), rtol=1e-9)
    moved = ts.evaluate(out.pos, n_deriv_evals=counter)[0]
    assert (moved - sim.energy_fn(ts.params)(out.pos)).abs().min() > 1e-3


def test_regenerated_extra_bundles_match_committed(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "export_torch_bundle",
        os.path.join(ROOT, "tools", "export_torch_bundle.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for name in ("ubiquitin_radial_synth", "ubiquitin_chi1_synth",
                 "trp_cage_extras_synth"):
        path = tool.build_bundle(name, str(tmp_path), str(tmp_path))
        new, pos_new = bundle.load(path)
        old, pos_old = bundle.load(os.path.join(DATA_DIR, name + ".npz"))
        np.testing.assert_array_equal(pos_new, pos_old)
        assert [(s.name, s.type_name, s.args) for s in new] == \
            [(s.name, s.type_name, s.args) for s in old]
        for a, b in zip(new, old):
            for part in ("consts", "params"):
                da, db = getattr(a, part), getattr(b, part)
                assert set(da) == set(db), (name, a.name, part)
                for k in da:
                    va, vb = np.asarray(da[k]), np.asarray(db[k])
                    assert va.dtype == vb.dtype and va.shape == vb.shape
                    np.testing.assert_array_equal(va, vb)
        new_aux, old_aux = bundle.load_aux(path), bundle.load_aux(
            os.path.join(DATA_DIR, name + ".npz"))
        assert set(new_aux) == set(old_aux)
        for sec, tables in old_aux.items():
            assert set(new_aux[sec]) == set(tables)
            for k, v in tables.items():
                np.testing.assert_array_equal(new_aux[sec][k], v)
    assert set(bundle.load_aux(os.path.join(
        DATA_DIR, "ubiquitin_chi1_synth.npz"))["chi1"]) == {
        "restype_order", "restype_and_chi_and_state", "sequence"}
    sizes = {n: os.path.getsize(os.path.join(DATA_DIR, n + ".npz"))
             for n in ("ubiquitin_radial_synth", "ubiquitin_chi1_synth",
                       "trp_cage_extras_synth")}
    assert sizes["ubiquitin_radial_synth"] < 4e6
    assert sizes["ubiquitin_chi1_synth"] < 1e6
    assert sizes["trp_cage_extras_synth"] < 1.5e6
