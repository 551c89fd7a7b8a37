"""The port's three examples (`examples/*_torch.py`) on the CPU at tiny
size, and the training demo against the JAX package's training.

* `fold_trp_cage_torch` (full force field on the committed synthetic
  libraries, smooth Rama maps) writes its `.up`, the slot's HDF5 file and
  the PDB and VTF exports, one model a frame;
* `replica_exchange_torch --hamiltonian` with 2 slots over one exchange
  interval writes each slot's `.up` and HDF5 file, its replica_index a
  permutation in every frame;
* `train_rotamer_torch.main` at 1 frame and 2 steps: the energy-gap loss
  falls;
* its training step against the JAX package's `fit_packed` /
  `energy_gap_loss` on the same trp-cage `.up` (built by the demo, read by
  the JAX `load_system`), float64, two configurations perturbed from a
  numpy seed, the same degraded table and target states: the loss
  history over 2 steps at rel 1e-4, as tests/test_torch_training.py holds
  it.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401 (autouse)
from upside_md_torch.io import h5
from upside_md_tpu import training as jt
from upside_md_tpu.config.reader import load_system

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fold_trp_cage_writes_its_files(tmp_path):
    fold = _example("fold_trp_cage_torch")
    work = str(tmp_path / "fold")
    pos = fold.main([work, "--duration", "0.054", "--device", "cpu"])
    for f in ("trpcage.up", "trpcage_0.h5", "traj.pdb", "traj.vtf"):
        assert os.path.getsize(os.path.join(work, f)) > 0, f
    assert pos.shape[0] == 2 and np.isfinite(pos).all()
    with open(os.path.join(work, "traj.pdb")) as f:
        assert f.read().count("MODEL") == 2


def test_replica_exchange_writes_each_slot(tmp_path):
    rex = _example("replica_exchange_torch")
    work = str(tmp_path / "rex")
    configs = rex.main([work, "--n-replica", "2", "--duration", "0.27",
                        "--hamiltonian", "--device", "cpu"])
    assert len(configs) == 2
    for i in range(2):
        with h5.File(os.path.join(work, f"rep{i}_{i}.h5")) as f:
            idx = np.asarray(f["output/replica_index"]).reshape(-1)
            assert len(idx) >= 2 and set(idx) <= {0, 1}
            assert np.isfinite(np.asarray(f["output/pos"])).all()


@pytest.fixture(scope="module")
def demo():
    return _example("train_rotamer_torch")


def test_train_rotamer_loss_falls(demo):
    history, acc0, acc1 = demo.main(n_frames=1, n_train_steps=2,
                                    device="cpu")
    assert len(history) == 2 and np.isfinite(history).all()
    assert history[-1] < history[0]
    assert 0.0 <= acc0 <= 1.0 and 0.0 <= acc1 <= 1.0


def test_train_rotamer_step_matches_jax(demo, tmp_path):
    path = demo.build_config(str(tmp_path / "trp_cage.up"))
    system, pos, _ = demo.load_config(path, "cpu", torch.float64)
    js, jparams, jpos, _ = load_system(path)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)
                      if np.asarray(a).dtype.kind == "f" else a, jparams)
    rng = np.random.default_rng(9)
    P = pos.numpy()[None] + 0.05 * rng.normal(size=(2,) + pos.shape)
    batch = torch.tensor(P)
    states = demo.rotamer_node_marginals(system, batch[0]).argmax(
        -1).numpy()

    seed = 3
    params_bad = demo.degrade(system.params, seed)
    fitted, hist_t = demo.train(system, batch, params_bad, states, 2)

    pk = jt.rotamer_packings(jp)["rotamer"]
    theta = np.asarray(pk.pack(jp["rotamer"]["interaction_param"]))
    theta_bad = theta + 0.4 * np.random.default_rng(seed).normal(
        size=theta.shape)
    jbad = {k: dict(v) for k, v in jp.items()}
    jbad["rotamer"]["interaction_param"] = pk.unpack(jnp.asarray(theta_bad))
    np.testing.assert_allclose(
        params_bad["rotamer"]["interaction_param"].numpy(),
        np.asarray(jbad["rotamer"]["interaction_param"]), rtol=1e-9,
        atol=1e-9)
    fixed = jt.rotamer_state_restricted_system(js, states)

    def loss_of_params(p):       # the JAX demo's loss, frame by frame
        total = 0.0
        for i in range(P.shape[0]):
            total = total + jt.energy_gap_loss(
                fixed, js, jnp.asarray(P[i]))(p, {})
        return total / P.shape[0]

    _, hist_j = jt.fit_packed(js, loss_of_params, jbad, ["rotamer"],
                              n_steps=2, learning_rate=0.02)
    rel = np.abs(np.subtract(hist_t, hist_j)).max() / np.abs(hist_j).max()
    assert rel < 1e-4, (hist_t, hist_j)
    assert np.isfinite(
        fitted["rotamer"]["interaction_param"].numpy()).all()
