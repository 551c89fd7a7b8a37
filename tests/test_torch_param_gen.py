"""The port's parameter-library tools (`upside_md_torch/param_gen.py`,
`sidechain_topology.py`) against the JAX package's, on the CPU
(mirroring tests/test_param_gen.py and tests/test_param_gen_parity.py).

`sidechain_topology` gives the same atoms bit for bit; `residue_frame`
(numpy float64 here, jax there) and `to_residue_frame` agree at rel
1e-12; the numpy-only functions bit for bit; `write_placement_library`
and `generate_sidechain_library` (with and without an interaction
source) write files whose contents equal the JAX package's as h5py reads
them back; `regenerate_fixed_centers` gives the same comparison on the
synthetic library.
"""

import numpy as np
import pytest

from upside_md_torch import param_gen as pp
from upside_md_torch import sidechain_topology as pt
from upside_md_tpu import param_gen as jp
from upside_md_tpu import sidechain_topology as jt

from test_torch_builder import assert_same_file, libs  # noqa: F401

RESTYPES = sorted(jt.N_CHI)


def test_sidechain_topology_equal():
    assert pt.N_CHI == jt.N_CHI
    rng = np.random.default_rng(0)
    for rt in RESTYPES:
        assert pt.atom_names(rt) == jt.atom_names(rt)
        psi, chi = rng.uniform(-np.pi, np.pi), rng.uniform(-np.pi, np.pi, 4)
        a, b = pt.residue_atoms(rt, psi, chi), jt.residue_atoms(rt, psi, chi)
        assert a.dtype == b.dtype and np.array_equal(a, b), rt


def test_residue_frame_matches_jax():
    rng = np.random.default_rng(1)
    N, CA, C = (rng.normal(size=(9, 3)) * 2 + o
                for o in ([-1.2, -0.8, 0.0], [0.0, 0.0, 0.0], [1.2, -0.9, 0]))
    R_p, t_p = pp.residue_frame(N, CA, C)
    R_j, t_j = jp.residue_frame(N, CA, C)
    assert R_p.shape == (9, 3, 3) and R_p.dtype == np.float64
    np.testing.assert_allclose(R_p, R_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(t_p, t_j, rtol=1e-12)
    pts = rng.normal(size=(9, 3)) * 4
    got, want = pp.to_residue_frame(pts, N, CA, C), jp.to_residue_frame(
        pts, N, CA, C)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    one = pp.to_residue_frame(pts[0], N[0], CA[0], C[0])
    np.testing.assert_allclose(one, want[0], rtol=0,
                               atol=1e-12 * np.abs(want).max())


def test_numpy_tools_bit_equal():
    rng = np.random.default_rng(2)
    args = ([0.3, -0.2, 0.1], [0.0, np.pi, np.pi / 3],
            [1.9, 1.9, 1.9], [1.5, 1.52, 1.43])
    assert np.array_equal(pp.build_sidechain_from_internal(*args),
                          jp.build_sidechain_from_internal(*args))
    pts = np.concatenate([rng.normal(size=(40, 3)),
                          rng.normal(size=(40, 3)) + 8.0])
    for x, y in zip(pp.kmeans_bead_centers(pts, 3, seed=4),
                    jp.kmeans_bead_centers(pts, 3, seed=4)):
        assert np.array_equal(x, y)
    phi, psi = rng.uniform(-np.pi, np.pi, (2, 300))
    rot, w = (phi > 0).astype(int) + (psi > 1), rng.uniform(size=300)
    assert np.array_equal(
        pp.rama_binned_rotamer_probs(phi, psi, rot, weights=w, n_bin=12),
        jp.rama_binned_rotamer_probs(phi, psi, rot, weights=w, n_bin=12))
    for atoms in (pts[:4], pts[:1] * 0):
        assert np.array_equal(pp.bead_direction(atoms, pts[5] * 0),
                              jp.bead_direction(atoms, pts[5] * 0))
    assert np.array_equal(pp.default_interaction_table(5, 3, repulsion=1.5),
                          jp.default_interaction_table(5, 3, repulsion=1.5))


def _samples(rng, restypes):
    out = {}
    for rt in restypes:
        n = 60
        out[rt] = dict(chi=rng.uniform(-np.pi, np.pi, (n, 4)),
                       phi=rng.uniform(-np.pi, np.pi, n),
                       psi=rng.uniform(-np.pi, np.pi, n),
                       rotamer=rng.integers(0, 3, n),
                       prob=rng.uniform(0.5, 1.0, n))
    return out


def test_write_placement_library_equal(tmp_path):
    rng = np.random.default_rng(3)
    data = {}
    for rt in RESTYPES:
        n_rot, nb = (1, 1) if rt in ("ALA", "GLY") else (3, 2)
        data[rt] = {"centers": rng.normal(size=(n_rot * nb, 6)),
                    "n_bead": nb,
                    "probs": None if rt == "SER" else rng.uniform(
                        0.01, 1.0, (36, 36, n_rot)),
                    "chi_table": [[0.5 * r, 0.0, r] for r in range(n_rot)]}
    for kw in ({}, {"bead_order": [f"b{i}" for i in range(37)]}):
        want = jp.write_placement_library(str(tmp_path / "j.h5"), data, **kw)
        got = pp.write_placement_library(str(tmp_path / "p.h5"), data, **kw)
        assert_same_file(got, want)


@pytest.mark.parametrize("source", [False, True])
def test_generate_sidechain_library_equal(tmp_path, libs, source):  # noqa: F811
    samples = _samples(np.random.default_rng(5),
                       ["ALA", "GLY", "SER", "LEU", "PHE", "LYS"])
    kw = dict(n_bead=2, n_bin=12, seed=3,
              interaction_source=libs["sidechain"] if source else None)
    want = jp.generate_sidechain_library(str(tmp_path / "j.h5"), samples,
                                         **kw)
    got = pp.generate_sidechain_library(str(tmp_path / "p.h5"), samples,
                                        **kw)
    assert_same_file(got, want)


def test_regenerate_fixed_centers_equal(libs):  # noqa: F811
    got = pp.regenerate_fixed_centers(libs["sidechain"])
    want = jp.regenerate_fixed_centers(libs["sidechain"])
    assert sorted(got) == sorted(want) == RESTYPES
    for rt in want:
        assert sorted(got[rt]) == sorted(want[rt])
        for k, v in want[rt].items():
            assert np.array_equal(np.asarray(got[rt][k]), np.asarray(v)), \
                (rt, k)
