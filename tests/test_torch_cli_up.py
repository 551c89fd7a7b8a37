"""The command line, `run.py`, the engine and chi1 on `.up` files, on the
CPU: trp-cage with the full force field, its `.up` written by the export
tool's `build_bundle` (the JAX `ConfigBuilder`) and its bundle exported
from that file with its sequence (`export_up`).

* `cli.main` on the `.up` writes the same frame files as on the bundle,
  bit for bit (every dataset and attribute but the invocation), with
  the same seed, two slots, pivot MC from the `.up`'s move tables; the
  `.up` itself is left as it was;
* `.up` and `.npz` configurations mix on one command line, and
  `run_upside` passes a `.up` through;
* `Upside("x.up")` evaluates as `Upside("x.npz")` and keeps the `.up`'s
  aux tables;
* `Chi1Predict.from_library` reads a sidechain library as `from_aux`
  and the JAX package's `Chi1Predict(sidechain_file)` do.
"""

import hashlib
import importlib.util
import os

import h5py
import numpy as np
import pytest
import torch

from upside_md_tpu.chi1 import Chi1Predict as JChi1Predict
from upside_md_torch import cli
from upside_md_torch.chi1 import Chi1Predict
from upside_md_torch.engine import Upside
from upside_md_torch.run import run_upside

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--duration=0.162", "--frame-interval=0.054", "--seed=9",
         "--temperature=0.8,0.9", "--monte-carlo-interval=0.054",
         "--log-level=extensive", "--device=cpu"]


def _tool():
    spec = importlib.util.spec_from_file_location(
        "export_torch_bundle",
        os.path.join(ROOT, "tools", "export_torch_bundle.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def trp(tmp_path_factory):
    """(library dir, .up, bundle exported from it with its sequence)."""
    tool = _tool()
    tmp = tmp_path_factory.mktemp("cli_up")
    lib = tmp / "lib"
    lib.mkdir()
    tool.build_bundle("trp_cage_full_synth", str(tmp), str(lib),
                      keep_up=True)
    up = str(tmp / "trp_cage_full_synth.up")
    npz = tool.export_up(up, str(tmp / "exported.npz"))
    return lib, up, npz


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _contents(path):
    """{object path: (values or None, attributes)} of an HDF5 file, the
    invocation left out."""
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            attrs = {k: v for k, v in obj.attrs.items() if k != "invocation"}
            out[name] = (obj[()] if isinstance(obj, h5py.Dataset) else None,
                         attrs)
        f.visititems(visit)
    return out


def test_cli_on_up_writes_the_bundles_frames(trp, tmp_path):
    _, up, npz = trp
    before = _digest(up)
    for name, config in (("up", up), ("npz", npz)):
        assert cli.main(FLAGS + [f"--output-dir={tmp_path / name}",
                                 config, config]) == 0
    assert _digest(up) == before
    for slot in range(2):
        got = _contents(cli.output_path(str(tmp_path / "up"), up, slot))
        want = _contents(cli.output_path(str(tmp_path / "npz"), npz, slot))
        assert sorted(got) == sorted(want)
        assert {"input/sequence", "output/pivot_stats"} <= set(got)
        for k, (g, ga) in got.items():
            w, wa = want[k]
            if w is not None:
                assert g.dtype == w.dtype, k
                np.testing.assert_array_equal(g, w, err_msg=k)
            assert sorted(ga) == sorted(wa), k
            for a in wa:
                np.testing.assert_array_equal(ga[a], wa[a], err_msg=k)


def test_up_and_npz_mix_and_run_upside_takes_up(trp, tmp_path):
    _, up, npz = trp
    assert cli.main(["--duration=0.054", "--frame-interval=0.027",
                     "--device=cpu", f"--output-dir={tmp_path / 'mix'}",
                     up, npz]) == 0
    for slot, config in enumerate((up, npz)):
        with h5py.File(cli.output_path(str(tmp_path / "mix"), config,
                                       slot), "r") as f:
            assert f["output/pos"].shape == (2, 1, 60, 3)
            assert f["input/sequence"].shape == (20,)
    out = str(tmp_path / "run")
    assert run_upside([up], 0.054, 0.027, device="cpu", output_dir=out,
                      seed=3) == 0
    with h5py.File(cli.output_path(out, up, 0), "r") as f:
        assert np.isfinite(f["output/potential"][()]).all()


def test_engine_reads_up(trp):
    _, up, npz = trp
    eng, ref = Upside(up, device="cpu"), Upside(npz, device="cpu")
    pos = ref._pos.numpy() + 0.05 * np.random.default_rng(0).normal(
        size=(60, 3))
    assert eng.energy(pos) == ref.energy(pos)
    np.testing.assert_array_equal(eng.deriv(pos), ref.deriv(pos))
    assert sorted(eng.aux) == sorted(ref.aux) == ["input", "pivot_moves"]
    np.testing.assert_array_equal(eng.aux["input"]["sequence"],
                                  ref.aux["input"]["sequence"])
    for k, v in ref.aux["pivot_moves"].items():
        np.testing.assert_array_equal(eng.aux["pivot_moves"][k], v)
    assert eng.system.device == torch.device("cpu")


def test_chi1_from_library_equals_from_aux(trp):
    lib, _, _ = trp
    path = str(lib / "sidechain_synth.h5")
    with h5py.File(path, "r") as f:
        aux = {"restype_order": f["restype_order"][()],
               "restype_and_chi_and_state":
                   f["restype_and_chi_and_state"][()]}
    got, want = Chi1Predict.from_library(path), Chi1Predict.from_aux(aux)
    ref = JChi1Predict(path)
    for p in (want, ref):
        np.testing.assert_array_equal(got.state_to_bin, p.state_to_bin)
        assert got.restype_dict == p.restype_dict
        assert (got.n_restype, got.n_state) == (p.n_restype, p.n_state)
