"""Chi1 prediction (BASELINE config 5) against the JAX package.

`ubiquitin_chi1_synth` is the prediction config of
`chi1.predict_chi1_from_pdb` (loose hbond, dynamic 1-body, damping 0.4)
on ubiquitin, with the synthetic sidechain library's chi1 table in its
aux section.  The JAX side reads that table from an h5 file written here
from the same aux, as `Chi1Predict` reads a library.

* `predict_chi1_from_bundle` over two configurations (float64, the CPU)
  against JAX `get_sens(pos, "hbond_coverage")` and JAX
  `Chi1Predict.predict_chi1` of each: probabilities atol 1e-6, every row
  summing to 1 within 2e-2 (as tests/test_chi1.py), ALA and GLY in bin 0.
* `Chi1Predict` alone on seeded posteriors: `predict_chi1`, its batched
  form on a tensor, and `compute_zero_one_stats` equal to JAX's.
* `predict_chi1_from_pdb` on a trp-cage PDB text (written by
  `io/trajectory.write_pdb` from the trp-cage bundle's positions), its
  config built by the port's builder from the committed synthetic
  sidechain library, against the JAX package's on the same text and
  library: probabilities within 1e-6; the `predict_chi1` command line's
  table equal to the JAX command line's (its 4-decimal probabilities to
  one unit of the last digit, as values 1e-6 apart may round apart).
"""

import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_nodes import jax_params64, jax_specs
from upside_md_tpu.chi1 import Chi1Predict as JChi1Predict
from upside_md_tpu.system import System as JSystem
from upside_md_torch import DATA_DIR, LIB_DIR
from upside_md_torch.chi1 import (Chi1Predict, predict_chi1_from_bundle,
                                  predict_chi1_from_pdb)
from upside_md_torch.config import bundle

CHI1 = os.path.join(DATA_DIR, "ubiquitin_chi1_synth.npz")


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """(port predictor, JAX predictor, aux, residue of each bead)."""
    aux = bundle.load_aux(CHI1)["chi1"]
    path = str(tmp_path_factory.mktemp("lib") / "sidechain_chi1.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("restype_order", data=np.asarray(
            aux["restype_order"], "S"))
        f.create_dataset("restype_and_chi_and_state",
                         data=aux["restype_and_chi_and_state"])
    records, _ = bundle.load(CHI1)
    sc = next(r for r in records
              if r.name == "placement_fixed_point_vector_only")
    return (Chi1Predict.from_aux(aux), JChi1Predict(path), aux,
            np.asarray(sc.consts["affine_residue"]))


def test_predict_chi1_from_bundle_matches_jax(library):
    _, jpred, aux, residue = library
    records, pos = bundle.load(CHI1)
    rng = np.random.default_rng(3)
    P = pos.astype(np.float64)[None] \
        + 0.05 * rng.normal(size=(2,) + pos.shape)
    prob, seq, elapsed = predict_chi1_from_bundle(CHI1, "cpu", P,
                                                  torch.float64)
    assert seq == [str(s) for s in aux["sequence"]] and len(seq) == 76
    assert prob.shape == (2, 76, 3) and elapsed > 0

    js = JSystem(len(pos), jax_specs(records))
    jp = jax_params64(js)
    sens = jax.jit(lambda x: js.get_sens(x, jp, "hbond_coverage"))
    for i in range(2):
        want = jpred.predict_chi1(seq, residue,
                                  np.asarray(sens(jnp.asarray(P[i])))[:, 0])
        np.testing.assert_allclose(prob[i].numpy(), want, rtol=0, atol=1e-6)
    rows = prob.sum(-1).numpy()
    assert np.abs(rows - 1.0).max() < 2e-2
    fixed = np.isin(seq, ("ALA", "GLY"))
    assert fixed.any()
    np.testing.assert_array_equal(prob[:, fixed].numpy(),
                                  np.broadcast_to([1.0, 0.0, 0.0],
                                                  (2, fixed.sum(), 3)))


def test_chi1_predict_matches_jax(library):
    pred, jpred, aux, residue = library
    seq = [str(s) for s in aux["sequence"]]
    rng = np.random.default_rng(8)
    post = rng.uniform(size=(3, len(residue)))
    for p in post:
        np.testing.assert_allclose(pred.predict_chi1(seq, residue, p),
                                   jpred.predict_chi1(seq, residue, p),
                                   rtol=1e-6, atol=1e-7)
    batched = pred.predict_chi1(seq, residue, torch.tensor(post))
    assert isinstance(batched, torch.Tensor) and batched.shape == (3, 76, 3)
    for i, p in enumerate(post):
        np.testing.assert_allclose(batched[i].numpy(),
                                   jpred.predict_chi1(seq, residue, p),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(pred.state_to_bin, jpred.state_to_bin)
    states = rng.integers(0, 3, size=len(seq))
    chi1_prob = jpred.predict_chi1(seq, residue, post[0])
    np.testing.assert_array_equal(
        pred.compute_zero_one_stats(seq, chi1_prob, states),
        jpred.compute_zero_one_stats(seq, chi1_prob, states))


SIDECHAIN = os.path.join(LIB_DIR, "sidechain_synth.h5")


@pytest.fixture(scope="module")
def trp_pdb(tmp_path_factory):
    """(path, text) of a trp-cage PDB and the JAX package's prediction.
    The JAX package's `System.get_sens` runs jitted here, as a caller
    would run it: its eager ops take ~30 s to warm up on the CPU."""
    from upside_md_torch.io.trajectory import write_pdb
    from upside_md_tpu.chi1 import predict_chi1_from_pdb as jax_predict
    from upside_md_tpu.bench_systems import TRP_CAGE
    from upside_md_tpu.config.builder import THREE_LETTER_AA

    _, pos = bundle.load(os.path.join(DATA_DIR, "trp_cage_full_synth.npz"))
    path = str(tmp_path_factory.mktemp("pdb") / "trp.pdb")
    write_pdb(path, [THREE_LETTER_AA[a] for a in TRP_CAGE], pos[None])
    with open(path) as f:
        text = f.read()
    eager = JSystem.get_sens

    def jitted(self, pos, params, name):
        return jax.jit(lambda x, p: eager(self, x, p, name))(pos, params)
    JSystem.get_sens = jitted
    try:
        yield path, text, jax_predict(text, SIDECHAIN)
    finally:
        JSystem.get_sens = eager


def test_predict_chi1_from_pdb_matches_jax(trp_pdb):
    _, text, (want, jinfo, _) = trp_pdb
    got, info, elapsed = predict_chi1_from_pdb(text, SIDECHAIN,
                                               device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == want.shape == (20, 3) and elapsed > 0
    assert info["sequence"] == jinfo["sequence"]
    np.testing.assert_array_equal(info["coords"], jinfo["coords"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_predict_chi1_command_line_matches_jax(trp_pdb, tmp_path, capsys):
    from upside_md_torch.chi1 import main as port_main
    from upside_md_tpu.chi1 import main as jax_main
    path = trp_pdb[0]
    jax_main([path, SIDECHAIN, str(tmp_path / "jax.txt")])   # jitted
    port_main([path, SIDECHAIN, str(tmp_path / "port.txt"), "--device",
               "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and all(ln.startswith("Time to compute ")
                                 and ln.endswith("for 20 residues")
                                 for ln in out)
    got = [ln.split() for ln in (tmp_path / "port.txt").read_text()
           .splitlines()]
    want = [ln.split() for ln in (tmp_path / "jax.txt").read_text()
            .splitlines()]
    assert len(got) == len(want) == 21 and got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        # the printed probabilities of values within 1e-6 of each other
        # may round apart by one unit of the last digit
        assert g[:4] + g[7:] == w[:4] + w[7:]
        assert max(abs(float(a) - float(b))
                   for a, b in zip(g[4:7], w[4:7])) <= 1.0001e-4
