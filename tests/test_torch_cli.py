"""The port's command line (`upside_md_torch.cli`, `run.py`) against the
JAX package's, on a 9-residue `.up` configuration built as
tests/test_cli_and_analysis.py builds one and exported to a bundle with
`tools/export_torch_bundle.export_up` (which stores its sequence).

* The files of one slot, and of four slots under replica exchange with
  two swap sets and pivot MC, at the extensive level: /output's dataset
  names, per-frame shapes, dtypes and frame counts equal to the JAX
  command line's for the same flags (run as a subprocess, as a user runs
  it); the JAX package's `load_upside_traj`, `load_upside_rep` and
  `sim_timeseries` read the port's files;
* the logged potential equals `System.energy` at the logged positions;
* `main` and a bare `run_ensemble` of the same seed and schedule reach
  bitwise-equal final positions and potentials;
* --set-param (a file written by h5py) gives the JAX engine's parameters,
  `rama_map_pot`'s refitted coefficients too;
* --potential-deriv-agreement prints the JAX package's per-term energies,
  and an error below 1e-2;
* --initial-structures recycles structures as the JAX package does;
* SIGINT to a `--device cpu` subprocess leaves every frame it printed in
  the file and a non-zero exit;
* `continue_sim` gives the /output_previous_0 -> /output chain, which the
  JAX reader stitches.
"""

import importlib.util
import os
import pickle
import signal
import subprocess
import sys
import time

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_cli_and_analysis import small_config
from upside_md_tpu.analysis import sim_timeseries as jax_timeseries
from upside_md_tpu.cli import recycle_structures as jax_recycle
from upside_md_tpu.config.reader import load_system
from upside_md_tpu.engine import Upside as JUpside
from upside_md_tpu.io.trajectory import load_upside_rep, load_upside_traj
from upside_md_torch import cli
from upside_md_torch.md.sim import Simulation
from upside_md_torch.run import continue_sim, run_upside
from upside_md_torch.system import System

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["--duration=0.81", "--frame-interval=0.27", "--seed=5",
          "--log-level=extensive"]
REX = ["--temperature=0.8,0.9,1.0,1.1", "--replica-interval=0.27",
       "--swap-set=0-1,2-3", "--swap-set=1-2", "--monte-carlo-interval=0.27"]


def _tool():
    spec = importlib.util.spec_from_file_location(
        "export_torch_bundle",
        os.path.join(ROOT, "tools", "export_torch_bundle.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The bundle, and the JAX and port files of both cases."""
    tmp = tmp_path_factory.mktemp("cli")
    up = small_config(tmp, "sys.up")
    npz = _tool().export_up(up, str(tmp / "sys.npz"))
    jax_paths = {"single": [small_config(tmp, "j.up")],
                 "rex": [small_config(tmp, f"r{i}.up") for i in range(4)]}
    flags = {"single": COMMON + ["--temperature=0.9"], "rex": COMMON + REX}
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    procs = {case: subprocess.Popen(
        [sys.executable, "-m", "upside_md_tpu.cli"] + flags[case]
        + jax_paths[case], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for case in jax_paths}
    port = {}
    for case, n in (("single", 1), ("rex", 4)):
        out = tmp / case
        assert cli.main(flags[case] + ["--device=cpu", f"--output-dir={out}"]
                        + [npz] * n) == 0
        port[case] = [cli.output_path(str(out), npz, i) for i in range(n)]
    for case, p in procs.items():
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err.decode()[-3000:]
    return dict(tmp=tmp, up=up, npz=npz, jax=jax_paths, port=port,
                flags=flags)


def _layout(path):
    with h5py.File(path, "r") as f:
        return {k: (v.shape[0], v.shape[1:], v.dtype)
                for k, v in f["output"].items()}


@pytest.mark.parametrize("case", ["single", "rex"])
def test_output_layout_matches_jax_cli(runs, case):
    for jpath, ppath in zip(runs["jax"][case], runs["port"][case]):
        want, got = _layout(jpath), _layout(ppath)
        assert got == want
        with h5py.File(ppath, "r") as f:
            assert "invocation" in f["output"].attrs
            assert f["input/pos"].shape == (27, 3, 1)
    assert _layout(ppath)["pos"][0] == 3


def test_jax_readers_read_port_files(runs):
    for path in runs["port"]["single"] + runs["port"]["rex"]:
        seq, t, pos = load_upside_traj(path)
        assert seq == ["MET", "LYS", "VAL", "LEU", "PHE", "GLU", "GLY",
                       "ALA", "ARG"]
        np.testing.assert_allclose(t, [0.27, 0.54, 0.81], rtol=1e-6)
        assert pos.shape == (3, 27, 3) and np.isfinite(pos).all()
        series = jax_timeseries(path)
        assert {k: v.shape for k, v in series.items()} == {
            "time": (3, 1), "potential": (3, 1), "kinetic": (3, 1),
            "temperature": (3, 1)}
    seq, t, demux = load_upside_rep(runs["port"]["rex"])
    assert demux.shape == (4, 3, 27, 3)
    with h5py.File(runs["port"]["rex"][0], "r") as f:
        assert f["output/replica_cumulative_swaps"].shape == (2, 3, 2)


def test_logged_potential_equals_energy(runs):
    system, _ = System.from_bundle(runs["npz"], device="cpu")
    for path in runs["port"]["rex"]:
        with h5py.File(path, "r") as f:
            pos = torch.as_tensor(f["output/pos"][:, 0])
            pot = f["output/potential"][:, 0]
        e = system.energy(pos).numpy()
        np.testing.assert_allclose(pot, e, rtol=1e-5)


def test_main_and_run_ensemble_bitwise_equal(runs, tmp_path):
    flags = ["--duration=0.81", "--frame-interval=0.27", "--seed=11",
             "--temperature=0.85", "--monte-carlo-interval=0.27"]
    assert cli.main(flags + ["--device=cpu", f"--output-dir={tmp_path}",
                             runs["npz"]]) == 0
    system, pos = System.from_bundle(runs["npz"], device="cpu")
    from upside_md_torch.config import bundle
    from upside_md_torch.md.mc import PivotSampler
    pm = bundle.load_aux(runs["npz"])["pivot_moves"]
    pivot = PivotSampler.from_tables(pm["pivot_atom"], pm["pivot_range"],
                                     pm["pivot_restype"], pm["proposal_pot"],
                                     device="cpu")
    sim = Simulation(system, dt=0.009, duration=0.81, frame_interval=0.27,
                     mc_interval=0.27, pivot_sampler=pivot, seed=11)
    state = sim.initial_state(pos[None], 1, [0.85])
    frames = []
    state, _ = cli.run_ensemble(sim, state, system.params, frozenset(),
                                sim.n_round, frame_callback=lambda d, v:
                                frames.append(v))
    with h5py.File(cli.output_path(str(tmp_path), runs["npz"], 0)) as f:
        np.testing.assert_array_equal(f["output/pos"][-1, 0],
                                      state.pos[0].numpy())
        np.testing.assert_array_equal(f["output/potential"][:, 0],
                                      [v["potential"][0] for v in frames])
        np.testing.assert_array_equal(f["output/pivot_stats"][()],
                                      [v["pivot_stats"][0] for v in frames])


def test_set_param_gives_jax_parameters(runs, tmp_path):
    rng = np.random.default_rng(4)
    js, jp, jpos, _ = load_system(runs["up"])
    eng = JUpside(js, jp, jnp.asarray(jpos))
    new = {name: np.asarray(eng.get_param(name)) * (1.0 + 0.1 * rng.normal(
        size=np.shape(eng.get_param(name)))) for name in
        ("dist_spring", "protein_hbond", "hbond_energy")}
    path = str(tmp_path / "p.h5")
    with h5py.File(path, "w") as f:
        for name, v in new.items():
            f[name] = v
    args = cli.parser().parse_args(["--duration=1", "--frame-interval=1",
                                    "--device=cpu", f"--set-param={path}",
                                    runs["npz"], runs["npz"]])
    system, params, spec, _, _ = cli.load_ensemble(args)
    assert not spec and params is system.params
    for name, v in new.items():
        eng.set_param(v, name)
        for k, want in eng.params[name].items():
            np.testing.assert_allclose(
                params[name][k].numpy(), np.asarray(want, np.float32),
                rtol=1e-6, err_msg=f"{name}/{k}")
    # the bundle has no raw Rama map; the hook refits the new one as JAX's
    with h5py.File(path, "w") as f:
        f["rama_map_pot"] = 0.5 * eng.get_param("rama_map_pot")
        eng.set_param(f["rama_map_pot"][()], "rama_map_pot")
    _, params, _, _, _ = cli.load_ensemble(args)
    np.testing.assert_array_equal(
        params["rama_map_pot"]["coeffs"].numpy(),
        np.asarray(eng.params["rama_map_pot"]["coeffs"]))


def test_potential_deriv_agreement_matches_jax(runs, tmp_path, capsys):
    assert cli.main(["--duration=0.027", "--frame-interval=0.027",
                     "--device=cpu", f"--output-dir={tmp_path}",
                     "--potential-deriv-agreement", runs["npz"]]) == 0
    out = capsys.readouterr().out.splitlines()
    js, jp, jpos, _ = load_system(runs["up"])
    per_term = js.evaluate(jnp.asarray(jpos), jp)[2]
    got = dict(line.split(":") for line in out[:len(per_term)])
    assert sorted(got) == sorted(per_term)
    for name, v in per_term.items():
        assert abs(float(got[name]) - float(v)) <= 1e-3 + 1e-5 * abs(
            float(v)), name
    rel = float(next(line for line in out if "relative error" in line)
                .split()[-1])
    assert rel < 1e-2
    system, pos = System.from_bundle(runs["npz"], device="cpu",
                                     dtype=torch.float64)
    # float64 at a small step: the batched differences match autograd
    assert cli.potential_deriv_agreement(system, system.params, pos,
                                         eps=1e-5, batch=50) < 1e-6


def test_initial_structures_recycle_as_jax(runs, tmp_path):
    rng = np.random.default_rng(6)
    structs = rng.normal(size=(3, 27, 3, 1)) * 5.0
    path = str(tmp_path / "s.pkl")
    with open(path, "wb") as f:
        pickle.dump(structs, f)
    want = jax_recycle(path, 4, 27)
    np.testing.assert_array_equal(cli.recycle_structures(path, 4, 27), want)
    out = tmp_path / "o"
    assert cli.main(["--duration=0.027", "--frame-interval=0.027",
                     "--device=cpu", f"--output-dir={out}",
                     f"--initial-structures={path}"] + [runs["npz"]] * 4) == 0
    for i in range(4):
        with h5py.File(cli.output_path(str(out), runs["npz"], i)) as f:
            np.testing.assert_allclose(f["input/pos"][:, :, 0], want[i],
                                       rtol=1e-6)


def test_sigint_keeps_flushed_frames(runs, tmp_path):
    p = subprocess.Popen(
        [sys.executable, "-m", "upside_md_torch.cli", "--duration=100",
         "--frame-interval=0.027", "--device=cpu",
         f"--output-dir={tmp_path}", runs["npz"]], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines = []
    deadline = time.time() + 120
    while len(lines) < 3 and time.time() < deadline:
        line = p.stdout.readline()
        if " / 100 " in line:
            lines.append(line)
    p.send_signal(signal.SIGINT)
    rest, err = p.communicate(timeout=120)
    assert p.returncode != 0, err[-2000:]
    printed = len(lines) + sum(" / 100 " in ln for ln in rest.splitlines())
    assert "exiting after signal" in rest
    with h5py.File(cli.output_path(str(tmp_path), runs["npz"], 0)) as f:
        assert f["output/pos"].shape[0] == printed >= 3
        assert f["output/time"].shape[0] == printed
        assert np.isfinite(f["output/pos"][()]).all()


def test_continue_sim_makes_an_output_chain(runs, tmp_path):
    out = str(tmp_path)
    assert run_upside([runs["npz"]], 0.54, 0.27, device="cpu",
                      output_dir=out, seed=3) == 0
    path = cli.output_path(out, runs["npz"], 0)
    with h5py.File(path, "r") as f:
        last = f["output/pos"][-1, 0]
    assert continue_sim([runs["npz"]], 0.54, 0.27, output_dir=out,
                        device="cpu", seed=4) == 0
    with h5py.File(path, "r") as f:
        assert sorted(f) == ["input", "output", "output_previous_0"]
        assert "invocation" in f["output_previous_0"].attrs
        np.testing.assert_array_equal(f["input/pos"][:, :, 0], last)
        assert f["output/pos"].shape[0] == 2
    seq, t, pos = load_upside_traj(path)
    assert pos.shape[0] == 4 and len(seq) == 9
    np.testing.assert_allclose(t, [0.27, 0.54, 0.27, 0.54], rtol=1e-6)
