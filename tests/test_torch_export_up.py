"""The export tool's `.up` path and the large bundles it writes.

* `--up PATH --name NAME`: a trp-cage `.up` written with the JAX package's
  `ConfigBuilder` (the synthetic libraries of the tool, a structure of
  its own seed, no rotamer damping override) is exported to a bundle; the
  port's energy and forces on that bundle equal the JAX System that
  `load_system` reads from the same `.up`, float64, rel 1e-6;
* `t4_lysozyme_full_synth` and `gfp_full_synth` regenerated by the tool
  match the committed bundles to 1e-6 (their Monte Carlo move tables
  exactly), with 164 and 238 residues and 770 and 1,143 rotamer beads.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upside_md_torch import DATA_DIR
from upside_md_torch.config import bundle
from upside_md_torch.system import System

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location(
        "export_torch_bundle",
        os.path.join(ROOT, "tools", "export_torch_bundle.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_trp_cage_up(tool, lib_dir):
    """A user's own config: trp-cage with the full force field."""
    from upside_md_tpu import bench_systems
    from upside_md_tpu.config.builder import ConfigBuilder
    rng = np.random.default_rng(5)
    sidechain = tool.write_sidechain_library(
        os.path.join(lib_dir, "sc.h5"), rng)
    environment = tool.write_environment_library(
        os.path.join(lib_dir, "env.h5"), rng)
    b = ConfigBuilder(f">trp\n{bench_systems.TRP_CAGE}\n", seed=3)
    b.add_backbone_springs()
    b.add_rama_map_pot(tool.smooth_rama_maps(b.n_res, rng))
    b.add_backbone_pairs()
    b.add_rotamer_sidechains(sidechain, sidechain, dynamic_1body=True)
    b.add_hbond(hbond_energy=-2.0, coverage_library=sidechain)
    b.add_environment(environment)
    b.add_rotamer_node()
    up = os.path.join(lib_dir, "my_trp_cage.up")
    b.write(up)
    return up


def test_up_export_matches_jax_load_system(tool, tmp_path):
    from upside_md_tpu.config.reader import load_system
    up = write_trp_cage_up(tool, str(tmp_path))
    tool.main(["--up", up, "--name", "exported", "--out", str(tmp_path)])
    path = os.path.join(str(tmp_path), "exported.npz")
    system, pos = System.from_bundle(path, device="cpu",
                                     dtype=torch.float64)
    js, jp, jpos, _ = load_system(up)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)
                      if np.asarray(a).dtype.kind == "f" else a, jp)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos, np.float64))
    P = np.asarray(jpos, np.float64) + 0.05 * np.random.default_rng(2) \
        .normal(size=jpos.shape)
    e_j, g_j = jax.jit(jax.value_and_grad(lambda x: js.energy(x, jp)))(
        jnp.asarray(P))
    g_t, e_t, _ = system.deriv(torch.tensor(P[None]))
    assert abs(e_t.item() - float(e_j)) <= 1e-6 * abs(float(e_j))
    g_j = np.asarray(g_j)
    assert np.sqrt(np.mean((g_t[0].numpy() - g_j) ** 2)) \
        <= 1e-6 * np.sqrt(np.mean(g_j ** 2))


def test_up_excludes_only(tool, tmp_path):
    with pytest.raises(SystemExit):
        tool.main(["--up", "x.up", "--only", "gfp_full_synth", "--out",
                   str(tmp_path)])


@pytest.mark.parametrize("name", ["t4_lysozyme_full_synth",
                                  "gfp_full_synth"])
def test_large_bundle_regenerates(tool, tmp_path, name):
    path = tool.build_bundle(name, str(tmp_path), str(tmp_path))
    assert tool.SIZES[name] == ((164, 770) if name.startswith("t4")
                                else (238, 1143))
    new, pos_new = bundle.load(path)
    old, pos_old = bundle.load(os.path.join(DATA_DIR, name + ".npz"))
    np.testing.assert_allclose(pos_new, pos_old, rtol=0, atol=1e-6)
    assert [(s.name, s.type_name, s.args) for s in new] == \
        [(s.name, s.type_name, s.args) for s in old]
    for a, b in zip(new, old):
        for part in ("consts", "params"):
            da, db = getattr(a, part), getattr(b, part)
            assert set(da) == set(db), (a.name, part)
            for k in da:
                va, vb = np.asarray(da[k]), np.asarray(db[k])
                assert va.dtype == vb.dtype and va.shape == vb.shape
                if va.dtype.kind == "f":
                    np.testing.assert_allclose(va, vb, rtol=1e-6, atol=1e-6,
                                               err_msg=f"{a.name}/{k}")
                else:
                    np.testing.assert_array_equal(va, vb)
    rot = [s for s in old if s.type_name == "rotamer"][0]
    assert (rot.consts["n_res"], len(rot.consts["index"])) == \
        tool.SIZES[name]
    new_aux = bundle.load_aux(path)
    old_aux = bundle.load_aux(os.path.join(DATA_DIR, name + ".npz"))
    assert set(new_aux) == set(old_aux) == {"pivot_moves"}
    for sec, tables in old_aux.items():
        for k, v in tables.items():
            np.testing.assert_array_equal(new_aux[sec][k], v)
