"""The port's trajectory, PDB and analysis tools (`upside_md_torch.io.
trajectory`, `io.pdb`, `analysis`) against the JAX package's, on the same
arrays and the same files (written by h5py, as the JAX logger writes
them, with a restart chain and three replica slots):

* `load_upside_traj` (with and without the chain and a stride),
  `load_upside_rep`, `reconstruct_virtual_atoms`, `write_vtf` and
  `write_pdb` (byte-identical text);
* `extract_initial_structure` and `main` of the PDB tools (identical
  outputs) on a PDB written by `write_pdb` plus side-chain atoms;
* `sim_timeseries`, `attr_overview` (identical text, attributes of every
  kind h5py writes), `diagnose_traj`, `rama_density`, `rdc`,
  `radius_of_gyration` and `rmsd`;
* `energy_blame` against the JAX one's values (float64, rel 1e-6) on a 9-residue
  configuration, and `profile_nodes`' rows on the port's System;
* a file without /input/sequence gives the port's reader a None
  sequence.
"""

import importlib.util
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_cli_and_analysis import small_config
from upside_md_tpu import analysis as janalysis
from upside_md_tpu.config.reader import load_system
from upside_md_tpu.io import pdb as jpdb
from upside_md_tpu.io import trajectory as jtraj
from upside_md_torch import analysis
from upside_md_torch.io import pdb, trajectory
from upside_md_torch.system import System

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = ["MET", "LYS", "PRO", "GLY", "ALA", "TRP", "CPR", "GLU"]


def _chain(rng, n_frame):
    """Backbone-like positions (n_frame, 3 n_res, 3): a helix with 1.5 A
    between neighbours, jittered."""
    t = np.arange(3 * len(SEQ))
    base = np.stack([1.2 * np.cos(t * 1.2), 1.2 * np.sin(t * 1.2),
                     0.6 * t], -1)
    return base + 0.1 * rng.normal(size=(n_frame,) + base.shape)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("traj")
    rng = np.random.default_rng(0)
    paths = []
    for slot in range(3):
        path = str(tmp / f"slot{slot}.h5")
        with h5py.File(path, "w") as f:
            f["input/sequence"] = np.array(SEQ, "S3")
            f["input/pos"] = _chain(rng, 1)[0][..., None]
            for g, n in (("output_previous_0", 4), ("output", 5)):
                grp = f.create_group(g)
                grp.attrs["invocation"] = f"run {slot} {g}"
                grp["pos"] = _chain(rng, n)[:, None].astype(np.float32)
                grp["time"] = np.arange(n) * 0.27
                grp["kinetic"] = rng.gamma(3.0, 0.5, (n, 1)).astype(
                    np.float32)
                grp["potential"] = rng.normal(size=(n, 1)).astype(np.float32)
                grp["temperature"] = np.full((n, 1), 0.9, np.float32)
                grp["replica_index"] = np.array(
                    [[(slot + k) % 3] for k in range(n)], np.int64)
        paths.append(path)
    return dict(tmp=tmp, paths=paths)


def test_trajectory_tools_match_jax(files, tmp_path):
    path = files["paths"][0]
    for kw in ({}, {"stride": 2}, {"include_previous": False}):
        got, want = trajectory.load_upside_traj(path, **kw), \
            jtraj.load_upside_traj(path, **kw)
        assert got[0] == want[0]
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(trajectory.load_upside_rep(files["paths"], 2)[1:],
                    jtraj.load_upside_rep(files["paths"], 2)[1:]):
        np.testing.assert_array_equal(a, b)
    seq, _, pos = jtraj.load_upside_traj(path)
    for breaks in ((0,), (0, 4)):
        got = trajectory.reconstruct_virtual_atoms(seq, pos, breaks)
        want = jtraj.reconstruct_virtual_atoms(seq, pos, breaks)
        assert got[:2] == want[:2]
        np.testing.assert_array_equal(got[2], want[2])
    for writer in ("write_vtf", "write_pdb"):
        a, b = str(tmp_path / f"p.{writer}"), str(tmp_path / f"j.{writer}")
        getattr(trajectory, writer)(a, seq, pos)
        getattr(jtraj, writer)(b, seq, pos)
        assert open(a).read() == open(b).read()


def test_no_sequence_reads_as_none(tmp_path):
    path = str(tmp_path / "noseq.h5")
    with h5py.File(path, "w") as f:
        f["output/pos"] = np.zeros((2, 1, 6, 3), np.float32)
    seq, t, pos = trajectory.load_upside_traj(path)
    assert seq is None and pos.shape == (2, 6, 3)
    np.testing.assert_array_equal(t, [0.0, 1.0])


def test_pdb_tools_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    pos = _chain(rng, 1)
    seq = [s if s != "CPR" else "PRO" for s in SEQ]
    jtraj.write_pdb(str(tmp_path / "in.pdb"), seq, pos)
    lines = open(tmp_path / "in.pdb").read().splitlines()
    extra, serial = [], 900
    for nr in range(len(seq)):       # side-chain atoms for the chi angles
        ca = pos[0, 3 * nr + 1]
        for k, name in enumerate(("CB", "CG", "CD")):
            x = ca + (k + 1) * np.array([0.9, 0.8 * (-1) ** k, 0.7])
            extra.append(f"ATOM  {serial:5d} {name:^4s}{seq[nr]:>4s} A"
                         f"{nr + 1:4d}    {x[0]:8.3f}{x[1]:8.3f}"
                         f"{x[2]:8.3f}  1.00  0.00")
            serial += 1
    text = "\n".join(lines[:-2] + extra + lines[-2:]) + "\n"
    open(tmp_path / "in.pdb", "w").write(text)
    got = pdb.extract_initial_structure(text)
    want = jpdb.extract_initial_structure(text)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    assert np.isfinite(np.asarray(got["chi"])).all()
    pdb.main([str(tmp_path / "in.pdb"), str(tmp_path / "port"),
              "--record-chain-breaks"])
    jpdb.main([str(tmp_path / "in.pdb"), str(tmp_path / "jax"),
               "--record-chain-breaks"])
    for ext in (".initial.pkl", ".fasta", ".chi"):
        a = open(str(tmp_path / "port") + ext, "rb").read()
        assert a == open(str(tmp_path / "jax") + ext, "rb").read(), ext


def test_analysis_functions_match_jax(files, tmp_path):
    path = files["paths"][1]
    got, want = analysis.sim_timeseries(path), janalysis.sim_timeseries(path)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert analysis.diagnose_traj(path, 1.0) == janalysis.diagnose_traj(
        path, 1.0)
    assert analysis.attr_overview(path) == janalysis.attr_overview(path)
    odd = str(tmp_path / "attrs.h5")
    with h5py.File(odd, "w") as f:
        f.attrs["vlen"] = "a string"
        f.attrs["num"] = 2.5
        f.attrs["arr"] = np.arange(3, dtype=np.int32)
        f.attrs["fixed"] = np.bytes_(b"x")
        f["g/d"] = np.zeros((2, 3), np.float32)
        f["g"].attrs["list"] = np.array([b"a", b"bc"])
    assert analysis.attr_overview(odd) == janalysis.attr_overview(odd)
    rng = np.random.default_rng(2)
    rama = rng.uniform(-np.pi, np.pi, (40, 2))
    np.testing.assert_allclose(analysis.rama_density(rama, n_bins=24),
                               janalysis.rama_density(rama, n_bins=24),
                               rtol=1e-12)
    pos = _chain(rng, 3)
    for (ea, pa), (eb, pb) in zip(analysis.rdc(pos[0]),
                                  janalysis.rdc(pos[0])):
        np.testing.assert_allclose(ea, eb, rtol=1e-10)
        np.testing.assert_allclose(pa, pb, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(analysis.radius_of_gyration(pos),
                               janalysis.radius_of_gyration(pos), rtol=1e-12)
    ref = _chain(rng, 1)[0]
    np.testing.assert_allclose(analysis.rmsd(pos, ref),
                               janalysis.rmsd(pos, ref), rtol=1e-6)
    assert analysis.rmsd(ref, ref) < 1e-6


def test_energy_blame_and_profile_on_port_system(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "export_torch_bundle",
        os.path.join(ROOT, "tools", "export_torch_bundle.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    up = small_config(tmp_path)
    npz = tool.export_up(up, str(tmp_path / "sys.npz"))
    js, jp, jpos, _ = load_system(up)
    system, _ = System.from_bundle(npz, device="cpu", dtype=torch.float64)
    pos = np.asarray(jpos, np.float64) + 0.05 * np.random.default_rng(
        3).normal(size=np.shape(jpos))
    # the JAX energy_blame's values (System.evaluate's per-term energies),
    # jitted: op by op it takes ~13 s
    want = {k: float(v) for k, v in jax.jit(
        lambda x: js.evaluate(x, jp)[2])(jnp.asarray(pos)).items()}
    got = analysis.energy_blame(system, None, pos)
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-6 * max(1.0, abs(v)), k
    rows = analysis.profile_nodes(system, None, pos, reps=2)
    assert {r[0] for r in rows} == {s.name for s in system.specs}
    assert all(us > 0 for _, us, _ in rows)
    assert abs(sum(p for _, _, p in rows) - 100.0) < 1e-6
