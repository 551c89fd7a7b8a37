"""The port's BASELINE builders (`upside_md_torch/bench_systems.py`)
against the JAX package's (`upside_md_tpu/bench_systems.py`) on the CPU.

Config 1 (trp-cage, backbone only) and config 3 (the 19-residue protein G
prefix of tests/test_config_end_to_end.py, on a 10 Å library written by
`synthetic_10A_library` from the committed synthetic sidechain library):
each package's builder runs as it is, its `.up` is kept as its reader
opens it, and the two files must be equal member for member through h5py
(tests/test_torch_builder.py's comparison).  The port's `System` on the
CPU in float64 from that file must give the JAX `load_system`'s energy and
forces at rel 1e-6.  The 10 Å library's tables have 40 parameters, the
(8, 12, 1.0) family in both packages.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_builder import assert_same_file
from upside_md_torch import bench_systems as pbs
from upside_md_torch.io import h5
from upside_md_torch.ops.pairs import quadspline_family
from upside_md_torch.system import System
from upside_md_tpu import bench_systems as jbs
from upside_md_tpu.ops.pairs import quadspline_family as jax_family

PROTEIN_G_PREFIX = jbs.PROTEIN_G[:19]


def keep_file(monkeypatch, module, name, dest):
    """Wrap module.<name> (the reader a builder calls on its temporary
    `.up`) so that the file is copied to `dest` before it is read."""
    read = getattr(module, name)

    def spy(path):
        shutil.copyfile(path, dest)
        return read(path)
    monkeypatch.setattr(module, name, spy)


def built_pair(monkeypatch, tmp_path, port_build, jax_build):
    """(port .up, JAX .up, the JAX build's (system, params, pos)), each
    builder run as it is."""
    port_up, jax_up = tmp_path / "port.up", tmp_path / "jax.up"
    keep_file(monkeypatch, pbs, "load_up", port_up)
    keep_file(monkeypatch, jbs, "load_system", jax_up)
    system, params, pos, _ = port_build()
    assert system.device == torch.device("cpu")
    assert pos.shape == (system.n_atom, 3)
    jsys, jparams, jpos, _ = jax_build()
    return port_up, jax_up, (jsys, jparams, jpos)


def assert_same_physics(port_up, jax_build):
    """Energy and forces of the port's float64 System from the `.up`
    against the JAX system's, rel 1e-6."""
    jsys, jparams, jpos = jax_build
    e_j, g_j = jax.jit(jax.value_and_grad(jsys.energy))(
        jnp.asarray(jpos, jnp.float64), jparams)
    system, pos = System.from_up(str(port_up), device="cpu",
                                 dtype=torch.float64)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    g, e, _ = system.deriv(pos[None], system.init_cache(1))
    e_j, g_j = float(e_j), np.asarray(g_j)
    assert abs(e.item() - e_j) <= 1e-6 * abs(e_j)
    err = np.abs(g[0].numpy() - g_j).max() / np.abs(g_j).max()
    assert err < 1e-6, err


def test_config1_backbone_trp_cage(monkeypatch, tmp_path):
    """BASELINE config 1: the same `.up` as the JAX builder's (its
    white-noise Rama map from default_rng(0) included), and the same
    energy and forces."""
    port_up, jax_up, jax_build = built_pair(
        monkeypatch, tmp_path,
        lambda: pbs.build_backbone_system(device="cpu"),
        jbs.build_backbone_system)
    assert_same_file(port_up, jax_up)
    assert_same_physics(port_up, jax_build)


def test_config3_10A_protein_g(monkeypatch, tmp_path):
    """BASELINE config 3 on the 19-residue protein G prefix: the port
    writes its 10 Å library in a temporary directory, the JAX builder reads
    one written by the same function; the files equal, and so do energy
    and forces through the 10 Å family's splines."""
    lib = pbs.synthetic_10A_library(str(tmp_path / "sidechain_10A.h5"))
    monkeypatch.setattr(jbs, "SIDECHAIN_10A", lib)
    monkeypatch.setattr(jbs, "ENVIRONMENT", pbs.ENVIRONMENT_SYNTH)
    port_up, jax_up, jax_build = built_pair(
        monkeypatch, tmp_path,
        lambda: pbs.build_10A_system(seq=PROTEIN_G_PREFIX, device="cpu"),
        lambda: jbs.build_10A_system(seq=PROTEIN_G_PREFIX))
    assert_same_file(port_up, jax_up)
    names = {s.node_type.name for s in jax_build[0].specs}
    assert {"rotamer", "environment_coverage"} <= names
    assert_same_physics(port_up, jax_build)


@pytest.mark.parametrize("table", pbs.TABLES_10A)
def test_10A_library_family(tmp_path, table):
    """Each rewritten table has 40 parameters, the (8, 12, 1.0) family in
    both packages; its angular and distance knots are the source's, the
    added distance knots 0; every other member is copied."""
    lib = pbs.synthetic_10A_library(str(tmp_path / "lib.h5"))
    with h5.File(lib) as new, h5.File(pbs.SIDECHAIN_SYNTH) as old:
        t, src = np.asarray(new[table][()]), np.asarray(old[table][()])
        assert sorted(new.keys()) == sorted(old.keys())
        for name in old.keys():
            if name not in pbs.TABLES_10A:
                np.testing.assert_array_equal(new[name][()], old[name][()])
    assert t.shape == src.shape[:-1] + (40,)
    assert quadspline_family(40) == jax_family(40) == (8, 12, 1.0)
    ka, k, _ = quadspline_family(src.shape[-1])
    np.testing.assert_array_equal(t[..., :2 * ka], src[..., :2 * ka])
    for seg in range(2):
        new_seg = t[..., 2 * ka + 12 * seg:2 * ka + 12 * (seg + 1)]
        np.testing.assert_array_equal(
            new_seg[..., :k], src[..., 2 * ka + k * seg:2 * ka + k * (seg + 1)])
        assert not new_seg[..., k:].any()
