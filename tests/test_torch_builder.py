"""The port's config builder (`upside_md_torch/config/builder.py`) against
the JAX package's (`upside_md_tpu/config/builder.py`) on the CPU.

Both builders get the same inputs (trp-cage and a 2-chain toy, libraries
written in tmp by `tools/export_torch_bundle.py`'s writers) and their
files are compared through h5py, the JAX package's reader: the same
groups and datasets, each dataset's dtype, shape and bytes, and every
attribute's type and value, as read back (the file bytes differ).  Each
`add_*` method alone, `build_bundle`'s order, the Rama library helpers,
`random_initial_config`, and the records the port's `.up` reader makes of
each file; one small trp-cage energy through the JAX `load_system`.  The
committed synthetic libraries (`upside_md_torch/data/libs`) are rebuilt
here and must equal the committed files, and the port's builder on them
must give the committed `ubiquitin_full_synth.up` bit for bit.
"""

import importlib.util
import os
import pickle

import h5py
import numpy as np
import pytest
import torch

from upside_md_torch import DATA_DIR, LIB_DIR
from upside_md_torch.config import builder as pb
from upside_md_torch.config.reader import load_up
from upside_md_tpu import bench_systems
from upside_md_tpu.config import builder as jb

from test_rama_library import make_library

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRP = bench_systems.TRP_CAGE
_TOOL = []


def tool():
    """tools/export_torch_bundle.py as a module (loaded once)."""
    if not _TOOL:
        spec = importlib.util.spec_from_file_location(
            "export_torch_bundle",
            os.path.join(ROOT, "tools", "export_torch_bundle.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _TOOL.append(mod)
    return _TOOL[0]


def _norm(v):
    if isinstance(v, np.ndarray):
        return ("array", v.dtype.str, v.shape,
                v.tolist() if v.dtype == object else v.tobytes())
    return (type(v).__name__, repr(v))


def contents(path, skip_attrs=()):
    """{member: (kind, dtype, shape, bytes, attrs)} of an HDF5 file as h5py
    reads it back, attributes by type and value (the root as "/")."""
    out = {}
    with h5py.File(path, "r") as f:
        def attrs(obj):
            return {k: _norm(v) for k, v in obj.attrs.items()
                    if k not in skip_attrs}
        out["/"] = ("group", attrs(f))

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                a = obj[()]
                out[name] = ("dataset", a.dtype.str, a.shape, a.tobytes(),
                             attrs(obj))
            else:
                out[name] = ("group", attrs(obj))
        f.visititems(visit)
    return out


def assert_same_file(got, want, skip_attrs=()):
    a, b = contents(got, skip_attrs), contents(want, skip_attrs)
    assert sorted(a) == sorted(b), sorted(set(a) ^ set(b))
    bad = [k for k in a if a[k] != b[k]]
    assert not bad, bad


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Every library a builder method reads, written by the export tool's
    writers (and test_rama_library's for the Rama dimer library)."""
    d = tmp_path_factory.mktemp("libs")
    t = tool()
    sc, env, rad = t.write_libs(str(d))
    rng = np.random.default_rng(t.EXTRA_LIB_SEED + 1)
    out = {"sidechain": sc, "environment": env, "radial": rad,
           "membrane": t.write_membrane_library(str(d / "membrane.h5"), rng),
           "torus": t.write_torus_library(str(d / "torus.h5"), rng),
           "rama": make_library(str(d / "rama.h5"), rng),
           "maps": t.smooth_rama_maps(len(TRP), rng, 24)}
    with open(d / "ref.pkl", "wb") as f:
        pickle.dump(rng.normal(size=(72, 72)), f)
    out["ref_pickle"] = str(d / "ref.pkl")
    return out


def _sidechains(b, L, **kw):
    kw.setdefault("damping", 0.1)
    b.add_rotamer_sidechains(L["sidechain"], L["sidechain"], **kw)


def _full(b, L):
    """tools/export_torch_bundle.build_bundle's order."""
    b.add_backbone_springs()
    b.add_rama_map_pot(L["maps"][:b.n_res])
    b.add_backbone_pairs()
    _sidechains(b, L, dynamic_1body=True)
    b.add_hbond(hbond_energy=-2.1119, coverage_library=L["sidechain"])
    b.add_environment(L["environment"])
    b.add_rotamer_node()


def _membrane(thickness):
    def case(b, L):
        _sidechains(b, L)
        b.add_hbond(hbond_energy=-2.0, coverage_library=L["sidechain"])
        b.add_environment(L["environment"])
        b.add_membrane_potential(L["membrane"], thickness,
                                 membrane_exclude_residues=[2, 5],
                                 hbond_exclude_residues=[0, 7])
    return case


def _chains(breaks, rl=None):
    def case(b, L):
        b.add_backbone_springs()
        b.add_rama_map_pot(L["maps"][:b.n_res])
        b.add_chain_breaks(breaks, rl_chains=rl, jump_length_scale=4.0,
                           jump_rotation_scale=20.0)
        b.add_hbond(hbond_energy=-2.0, exclude_residues=[
            r + j for r in breaks for j in (-1, 0)])
        b.add_restraint_group([1, 2, 3, 12, 13], strength=2.5)
    return case


CASES = {
    "backbone_springs": lambda b, L: b.add_backbone_springs(40.0, 150.0,
                                                            25.0),
    "rama_map_pot": lambda b, L: b.add_rama_map_pot(L["maps"]),
    "rama_map_pot_shared": lambda b, L: b.add_rama_map_pot(
        L["maps"][:3], rama_map_id=np.arange(b.n_res) % 3,
        center_maps=False),
    "rama_library_mixture": lambda b, L: b.add_rama_map_pot_from_library(
        L["rama"]),
    "rama_library_sheet": lambda b, L: b.add_rama_map_pot_from_library(
        L["rama"], sheet_mixing=0.7),
    "rama_library_product": lambda b, L: b.add_rama_map_pot_from_library(
        L["rama"], mode="product"),
    "torus_dbn": lambda b, L: b.add_torus_dbn(L["torus"]),
    "affine_alignment": lambda b, L: b.add_affine_alignment(),
    "backbone_pairs": lambda b, L: b.add_backbone_pairs(),
    "CB_placement": lambda b, L: b.add_CB_placement(),
    "hbond": lambda b, L: b.add_hbond(-2.0, exclude_residues=[3, 4]),
    "hbond_loose": lambda b, L: b.add_hbond(-1e-5, loose=True),
    "rotamer_dynamic": lambda b, L: (
        _sidechains(b, L, dynamic_1body=True),
        b.add_hbond(-2.1119, coverage_library=L["sidechain"]),
        b.add_rotamer_node()),
    "rotamer_fixed": lambda b, L: (
        _sidechains(b, L, damping=0.4, dynamic_1body=False,
                    fix_rotamer={2: 1, 5: 0}),
        b.add_rotamer_node()),
    "environment": lambda b, L: (
        _sidechains(b, L), b.add_environment(L["environment"]),
        b.add_rotamer_node()),
    "cavity_radial": lambda b, L: b.add_cavity_radial(12.0, 3.0),
    "contacts": lambda b, L: b.add_contacts(
        [[0, 5], [2, 9]], [-1.0, -0.5], [6.0, 7.0], [2.0, 2.5]),
    "sidechain_radial": lambda b, L: b.add_sidechain_radial(
        L["radial"], exclude_residues=[1, 2], suffix="_x"),
    "target": lambda b, L: b.add_target_structure(b.pos + 1.0),
    "z_flat_bottom": lambda b, L: b.add_z_flat_bottom(
        [(3, 0.0, 2.0, 1.0), (7, 1.0, 1.5, 2.0)]),
    "tension": lambda b, L: b.add_tension([(0, 0.05, 0.0, -0.02)]),
    "afm": lambda b, L: b.add_afm([(4, 2.0, 1.0, 0.0, 0.0, 0.01, 0.0, 0.0)],
                                  time_initial=3.0, time_step=0.01),
    "restraint_group": lambda b, L: (
        b.add_backbone_springs(),
        b.add_restraint_group([2, 3, 4, 7], strength=3.0)),
    "membrane_thinner": _membrane(24.0),
    "membrane_same": _membrane(30.0),
    "membrane_thicker": _membrane(36.0),
    "chain_breaks": _chains([10]),
    "chain_breaks_rl": _chains([7, 14], rl=[1, 2]),
    "bundle_order": _full,
    "bundle_order_two_chains": lambda b, L: (
        _full(b, L), b.add_chain_breaks([10])),
}


def build_both(tmp_path, case, libs, seq=TRP, seed=1, **kw):
    paths = []
    for mod, tag in ((jb, "jax"), (pb, "port")):
        b = mod.ConfigBuilder(f">x\n{seq}\n", seed=seed, **kw)
        case(b, libs)
        paths.append(b.write(str(tmp_path / f"{tag}.up")))
    return paths


@pytest.mark.parametrize("name", sorted(CASES))
def test_builder_writes_the_jax_file(tmp_path, libs, name):
    seq = "ALGPALLGALGPAL" if name.startswith("rama_library") else TRP
    want, got = build_both(tmp_path, CASES[name], libs, seq=seq)
    assert_same_file(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_initial_config_bit_equal(seed):
    a = jb.random_initial_config(len(TRP), seed)
    b = pb.random_initial_config(len(TRP), seed)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(pb.ConfigBuilder(f">x\n{TRP}\n", seed=seed).pos,
                          jb.ConfigBuilder(f">x\n{TRP}\n", seed=seed).pos)
    assert pb.parse_fasta("AC*PG").tolist() == jb.parse_fasta(
        "AC*PG").tolist() == ["ALA", "CYS", "CPR", "GLY"]


def _same_records(a, b):
    assert [(r.name, r.type_name, r.args) for r in a] == \
        [(r.name, r.type_name, r.args) for r in b]
    for x, y in zip(a, b):
        for part in ("consts", "params"):
            da, db = getattr(x, part), getattr(y, part)
            assert set(da) == set(db)
            for k in da:
                if isinstance(db[k], np.ndarray):
                    assert da[k].dtype == db[k].dtype
                    assert np.array_equal(da[k], db[k]), (x.name, k)
                elif k != "bp":
                    assert da[k] == db[k], (x.name, k)


@pytest.mark.parametrize("name", ["bundle_order", "bundle_order_two_chains",
                                  "membrane_same", "torus_dbn"])
def test_reader_gives_equal_records(tmp_path, libs, name):
    want, got = build_both(tmp_path, CASES[name], libs)
    (ra, pa, xa), (rb, pb_, xb) = load_up(got), load_up(want)
    _same_records(ra, rb)
    assert np.array_equal(pa, pb_)
    assert sorted(xa) == sorted(xb)
    for sec in xa:
        for k, v in xb[sec].items():
            assert np.array_equal(np.asarray(xa[sec][k]), np.asarray(v))


def test_small_energy_against_load_system(tmp_path, libs):
    """One evaluation: the port's System from the port's file against the
    JAX package's load_system on its own file (trp-cage's springs, Rama
    maps and hydrogen bonds)."""
    import jax
    import jax.numpy as jnp
    from upside_md_torch.system import System
    from upside_md_tpu.config.reader import load_system

    def case(b, L):
        b.add_backbone_springs()
        b.add_rama_map_pot(L["maps"])
        b.add_hbond(-2.1119)
    want, got = build_both(tmp_path, case, libs)
    system, params, pos, _ = load_system(want)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)
                          if np.asarray(a).dtype.kind == "f" else a, params)
    e_jax = float(system.energy(jnp.asarray(pos, jnp.float64), params))
    sys_t, pos_t = System.from_up(got, "cpu", torch.float64)
    e_port = float(sys_t.energy(pos_t[None])[0])
    assert abs(e_port - e_jax) <= 1e-6 * abs(e_jax), (e_port, e_jax)


def test_rama_helpers_equal_jax(tmp_path, libs):
    rng = np.random.default_rng(3)
    w, F = rng.uniform(0.5, 2.0, (2, 4)), rng.normal(size=(2, 4, 6, 6))
    assert np.array_equal(pb.mixture_potential(w, F),
                          jb.mixture_potential(w, F))
    seq = ["ALA", "CPR", "LEU", "PRO", "GLY", "ALA"]
    for mode in ("mixture", "product"):
        for mix in (None, 0.4):
            a = pb.read_weighted_maps(seq, libs["rama"], mix, mode)
            b = jb.read_weighted_maps(seq, libs["rama"], mix, mode)
            assert a.dtype == b.dtype and np.array_equal(a, b), (mode, mix)
    entries = [(1, "helix", -0.8), (3, "sheet", 0.5)]
    pot = rng.normal(size=(5, 18, 18))
    assert np.array_equal(pb.apply_secstr_bias(pot, entries),
                          jb.apply_secstr_bias(pot, entries))
    assert np.array_equal(
        pb.uniform_rama_maps_from_reference(4, libs["ref_pickle"]),
        jb.uniform_rama_maps_from_reference(4, libs["ref_pickle"]))


def test_committed_libraries_rebuild_equal(tmp_path):
    """`tools/export_torch_bundle.py --libs` writes the committed files."""
    for path in tool().write_libs(str(tmp_path)):
        name = os.path.basename(path)
        assert_same_file(path, os.path.join(LIB_DIR, name))
    assert sorted(os.listdir(LIB_DIR)) == [
        "environment_synth.h5", "radial_synth.h5", "sidechain_synth.h5"]
    assert sum(os.path.getsize(os.path.join(LIB_DIR, f))
               for f in os.listdir(LIB_DIR)) < 0.8e6


def test_committed_up_rebuilt_bit_for_bit(tmp_path):
    """The port's builder on the committed libraries, in build_bundle's
    order, with the committed `.up`'s centred Rama maps passed as they are
    (`center_maps=False`), gives that `.up` again."""
    from upside_md_torch.io import h5
    up = os.path.join(DATA_DIR, "ubiquitin_full_synth.up")
    with h5.File(up) as f:
        maps = f["input/potential/rama_map_pot/rama_pot"][()]
    sc = os.path.join(LIB_DIR, "sidechain_synth.h5")
    b = pb.ConfigBuilder(f">x\n{bench_systems.UBIQUITIN}\n", seed=1)
    b.add_backbone_springs()
    b.add_rama_map_pot(maps, center_maps=False)
    b.add_backbone_pairs()
    b.add_rotamer_sidechains(sc, sc, damping=0.1, dynamic_1body=True)
    b.add_hbond(hbond_energy=-2.1119, coverage_library=sc)
    b.add_environment(os.path.join(LIB_DIR, "environment_synth.h5"))
    b.add_rotamer_node()
    assert_same_file(b.write(str(tmp_path / "ubq.up")), up)
