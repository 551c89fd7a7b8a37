"""The port's flagship entry point (`upside_md_torch/entry.py`) against the
JAX package, on the CPU.

* `entry(small=True)`: the trp-cage full-force-field bundle in float64,
  its forward step (energy, forces = -grad) against the JAX System on the
  same bundle (`load_pair`): energy rel 1e-6, forces RMS rel 1e-4, as
  tests/test_torch_slice.py holds the whole graph;
* `forward_step` on `bench_systems.build_backbone_system(seq=UBIQUITIN)`
  against the JAX `__graft_entry__.entry()` itself, which without the
  reference's libraries builds the same backbone-only ubiquitin from an
  identical `.up` (tests/test_torch_bench_systems.py).  Both in float64
  (the JAX forward on its example arguments cast): observed energy rel
  2.6e-16 and forces RMS rel 2.4e-13, held at 1e-10 and 1e-9.  In
  float32, as the JAX entry's arguments come, the forces differ by RMS
  rel 1.3e-4 between the packages, and by the same between the JAX
  forward in float32 and in float64: rounding on the white-noise Rama
  map (rama_map_pot ~1e5), not a fault;
* `dryrun_multichip` is `parallel.dryrun.run`, and the command line prints
  the flagship's energy.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401 (autouse)
from test_torch_nodes import TRP, load_pair
from upside_md_torch import bench_systems, entry
from upside_md_torch.parallel import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rms_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2))


def test_small_entry_matches_jax_system():
    _, pos, js, jp, _ = load_pair(TRP)
    forward, (pos0, params) = entry.entry(small=True, device="cpu",
                                          dtype=torch.float64)
    np.testing.assert_array_equal(pos0.numpy(), pos)
    rng = np.random.default_rng(5)
    P = pos.astype(np.float64) + 0.05 * rng.normal(size=pos.shape)
    e_j, g_j = jax.jit(jax.value_and_grad(js.energy))(jnp.asarray(P), jp)
    energy, forces = forward(torch.tensor(P), params)
    assert energy.shape == () and forces.shape == pos.shape
    assert abs(energy.item() - float(e_j)) <= 1e-6 * abs(float(e_j))
    assert _rms_rel(forces.numpy(), -np.asarray(g_j)) < 1e-4
    # a batch gives each configuration's own
    e2, f2 = forward(torch.tensor(np.stack([P, pos])), params)
    assert e2.shape == (2,) and f2.shape == (2,) + pos.shape
    assert abs(e2[0].item() - energy.item()) <= 1e-12 * abs(energy.item())


def test_forward_matches_jax_graft_entry_backbone_fallback():
    assert not bench_systems.have_reference_params()
    sys.path.insert(0, ROOT)
    import __graft_entry__
    fn, (jpos, jparams) = __graft_entry__.entry()
    f64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)
                       if np.asarray(a).dtype.kind == "f" else a,
                       (jpos, jparams))
    e_j, f_j = jax.jit(fn)(*f64)
    system, params, pos, _ = bench_systems.build_backbone_system(
        seq=bench_systems.UBIQUITIN, device="cpu")
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    system64 = type(system)(system.n_atom, system.specs, "cpu",
                            torch.float64)
    energy, forces = entry.forward_step(system64)(pos.double(),
                                                  system64.params)
    e_rel = abs(energy.item() - float(e_j)) / abs(float(e_j))
    f_rel = _rms_rel(forces.numpy(), f_j)
    assert e_rel < 1e-10, e_rel
    assert f_rel < 1e-9, f_rel


def test_dryrun_and_command_line(capsys, monkeypatch):
    assert entry.dryrun_multichip is dryrun.run
    assert entry.main(["--small", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("entry ok: ")
    assert np.isfinite(float(line.split(": ")[1]))
    # the default device is the card: without one it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()
