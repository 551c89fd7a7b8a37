"""The port past 1,024 beads against the JAX package, on the 238-residue
GFP bundle (1,143 sidechain beads: the rotamer grid and both coverage
nodes take the fixed-K neighbour list, upside_md_tpu/ops/pairs.py:63-131,
and BP runs on residue planes by the port of the XLA `_bp_solve`).

* energy, per-term energies and forces of the whole graph: port vs the JAX
  System on the CPU, both in float64: rel 1e-4, forces as RMS relative
  error; the rotamer grid's list held min(1143, 128) partners a bead, the
  coverages' 96, and the rotamer took the planes branch with R = 238;
* the port's large-protein paths (neighbour lists, the plain BP solve
  past 128 residues, one Verlet round) run with jax, h5py and
  upside_md_tpu blocked;
* the bundle's size: under 10 MB.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import upside_md_torch.nodes.hbond as thb
import upside_md_torch.nodes.rotamer as trot
from test_torch_nodes import load_pair
from upside_md_torch import DATA_DIR
from upside_md_torch.ops import pairs as tpairs

GFP = os.path.join(DATA_DIR, "gfp_full_synth.npz")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def calls(monkeypatch):
    """The widths of the port's neighbour-list calls and the residue
    counts of its residue-plane solves."""
    got = {"nl": [], "planes": []}
    real_nl, real_planes = tpairs.quadspline_coverage_nl, trot.bp_bethe_planes

    def nl(*args, **kw):
        got["nl"].append(args[-1])
        return real_nl(*args, **kw)

    def planes(st, *args, **kw):
        got["planes"].append(st.n_res)
        return real_planes(st, *args, **kw)

    monkeypatch.setattr(trot, "quadspline_coverage_nl", nl)
    monkeypatch.setattr(thb, "quadspline_coverage_nl", nl)
    monkeypatch.setattr(trot, "bp_bethe_planes", planes)
    return got


def test_gfp_energy_terms_and_forces_match_jax(calls):
    records, pos, js, jp, ts = load_pair(GFP)
    rot = [s for s in records if s.type_name == "rotamer"][0]
    assert (rot.consts["n_res"], len(rot.consts["index"])) == (238, 1143)
    P = pos.astype(np.float64) + 0.05 * np.random.default_rng(29).normal(
        size=pos.shape)

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
    assert sorted(calls["nl"]) == [96, 96, 128]
    assert calls["planes"] == [238]
    assert set(per_t) == set(per_j)
    for name, v in per_t.items():
        assert abs(v.item() - float(per_j[name])) <= \
            1e-4 * max(1.0, abs(float(per_j[name]))), name
    assert abs(total.item() - float(e_j)) <= 1e-4 * abs(float(e_j))
    g_j = np.asarray(g_j)
    assert np.sqrt(np.mean((g_t[0].numpy() - g_j) ** 2)) \
        < 1e-4 * np.sqrt(np.mean(g_j ** 2))


def test_bundle_size():
    assert os.path.getsize(GFP) < 1e7


BLOCKED_LARGE = r"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "h5py", "upside_md_tpu"):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
import torch
from upside_md_torch.md.sim import Simulation
from upside_md_torch.system import System
system, pos = System.from_bundle(sys.argv[2], device="cpu")
sim = Simulation(system, seed=0)
state = sim.advance(sim.initial_state(pos, 1), 1)
assert bool(torch.isfinite(state.pos).all())
assert state.cache["rotamer"]["nb"].shape == (1, 238, 6)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "h5py", "upside_md_tpu")]
assert not bad, bad
print("isolated ok")
"""


def test_large_paths_import_without_jax_h5py_or_reference():
    r = subprocess.run([sys.executable, "-c", BLOCKED_LARGE, ROOT, GFP],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "isolated ok" in r.stdout
