"""The port's `.up` reader (`upside_md_torch/config/reader.py`) against the
JAX package's (`upside_md_tpu/config/reader.py` through h5py), on the CPU.

* Every one of the 42 node types: the port's records equal
  `convert.from_jax_specs(load_system(path)[0].specs)` (names, types,
  args, keys, dtypes and Python scalars; integer and bool arrays exactly,
  floats within rel 1e-6), plus `rama_map_pot`'s raw map, which the JAX
  spec keeps and a bundle drops.  The files: trp-cage with the full force
  field and with every config-builder extra, written by the export tool's
  `build_bundle` (the JAX `ConfigBuilder`); the extras file with the
  hand-built graph of `config/extras_graph.py` added as h5py groups (the
  types no ConfigBuilder method writes); the reference-writer-shaped backbone
  and sidechain files of tests/test_reference_up_roundtrip.py, the
  sidechain one on the tool's synthetic libraries.
* Group names resolve to the JAX registry's types.
* The committed `ubiquitin_full_synth.up`: the JAX reader gives the
  committed bundle's records exactly, and so does the port's.
* `System.from_up` against the JAX System of the same trp-cage `.up`:
  energy and forces in float64, rel 1e-6.
* A copy with gzip, shuffle and fletcher32 on every dataset reads to the
  same records; a flipped byte raises; an unknown filter raises with its
  name.
"""

import importlib.util
import os
import shutil

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import chain_positions
from test_reference_up_roundtrip import (SC_SEQ, SEQ3,
                                         _write_reference_style_sidechain_up,
                                         _write_reference_style_up)
from upside_md_tpu.config.reader import READERS as JAX_READERS
from upside_md_tpu.config.reader import load_system
from upside_md_tpu.nodes.base import resolve_node_type as jax_resolve
from upside_md_torch import DATA_DIR, config
from upside_md_torch.config import bundle, reader
from upside_md_torch.config.extras_graph import extras_graph
from upside_md_torch.convert import from_jax_specs
from upside_md_torch.io import h5
from upside_md_torch.system import System

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UBQ = os.path.join(DATA_DIR, "ubiquitin_full_synth")


def _tool():
    spec = importlib.util.spec_from_file_location(
        "export_torch_bundle",
        os.path.join(ROOT, "tools", "export_torch_bundle.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_record(pot, r):
    """A hand-built SpecRecord as the `.up` group the JAX reader reads
    (config/reader.py:48-290): Python scalars as attributes, the
    featurizer's hbond columns as one `hbond_idx`, a Rama placement's
    surface as its raw `placement_data`, the uniform transform's offset
    and scale on its coefficients."""
    g = pot.create_group(r.name)
    g.attrs["arguments"] = np.asarray(r.args, "S")
    values = {**r.consts, **r.params}
    if r.type_name == "backbone_featurizer":
        values["hbond_idx"] = np.stack([values.pop("donor_idx"),
                                        values.pop("acceptor_idx")], 1)
    if "coeffs" in values:
        values["placement_data"] = values.pop("coeffs")
    spline = {k: values.pop(k) for k in ("spline_offset", "spline_inv_dx")
              if k in values}
    for k, v in values.items():
        if isinstance(v, (int, float, str)):
            g.attrs[k] = v
        else:
            g.create_dataset(k, data=v)
    for k, v in spline.items():
        g["bspline_coeff"].attrs[k] = v


@pytest.fixture(scope="module")
def ups(tmp_path_factory):
    """{case: .up path}: every file the parity tests read."""
    tmp = tmp_path_factory.mktemp("reader")
    tool = _tool()
    lib = tmp / "lib"
    lib.mkdir()
    out = {}
    for name in ("trp_cage_full_synth", "trp_cage_extras_synth"):
        tool.build_bundle(name, str(tmp), str(lib), keep_up=True)
        out[name] = str(tmp / f"{name}.up")
    hand = str(tmp / "trp_cage_extras_hand.up")
    shutil.copyfile(out["trp_cage_extras_synth"], hand)
    records, pos = bundle.load(str(tmp / "trp_cage_extras_synth.npz"))
    with h5py.File(hand, "r+") as f:
        for r in extras_graph(records, pos)[len(records):]:
            _write_record(f["input/potential"], r)
    out["extras_hand"] = hand
    rng = np.random.default_rng(0)
    out["reference_backbone"] = _write_reference_style_up(
        str(tmp / "ref.up"), SEQ3, chain_positions(len(SEQ3), rng),
        0.4 * rng.normal(size=(len(SEQ3), 18, 18)))
    out["reference_sidechain"] = _write_reference_style_sidechain_up(
        str(tmp / "ref_sc.up"), SC_SEQ, chain_positions(len(SC_SEQ), rng),
        str(lib / "sidechain_synth.h5"), str(lib / "environment_synth.h5"))
    return out


@pytest.fixture(scope="module")
def loaded(ups):
    """{case: (JAX records, JAX raw maps, JAX pos, port records, pos,
    aux)}."""
    out = {}
    for case, path in ups.items():
        js, _, jpos, _ = load_system(path)
        jrec, jpos = from_jax_specs(js.specs, jpos)
        raw = {s.name: np.asarray(s.consts["raw_map"]) for s in js.specs
               if s.node_type.name == "rama_map_pot"}
        out[case] = (jrec, raw, jpos) + reader.load_up(path)
    return out


def assert_same_values(got, want, where, rtol=1e-6):
    """Keys, kinds and dtypes equal; integer and bool arrays exactly,
    floats within rtol of the largest |value|; Python scalars by type and
    value."""
    assert sorted(got) == sorted(want), where
    for k, w in want.items():
        g = got[k]
        if not isinstance(w, np.ndarray):
            assert type(g) is type(w) and g == w, (where, k, g, w)
            continue
        assert isinstance(g, np.ndarray), (where, k)
        assert g.dtype == w.dtype and g.shape == w.shape, (where, k)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(
                g, w, rtol=0, atol=rtol * max(np.abs(w).max(initial=0), 1e-30),
                err_msg=f"{where}/{k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{where}/{k}")


def assert_same_records(got, want, raw, where, rtol=1e-6):
    """The port's records against the JAX reader's converted ones (order
    free), rama_map_pot's raw map against the JAX spec's."""
    got = {r.name: r for r in got}
    assert sorted(got) == sorted(r.name for r in want), where
    for w in want:
        g = got[w.name]
        assert (g.type_name, g.args) == (w.type_name, w.args), w.name
        consts, want_consts = dict(g.consts), dict(w.consts)
        if w.type_name == "rama_map_pot":
            np.testing.assert_array_equal(consts.pop("raw_map"),
                                          raw[w.name])
            want_consts.pop("raw_map", None)
        assert_same_values(consts, want_consts, f"{where}:{w.name}", rtol)
        assert_same_values(g.params, w.params, f"{where}:{w.name}", rtol)


@pytest.mark.parametrize("type_name", sorted(JAX_READERS))
def test_node_type_matches_jax_reader(loaded, type_name):
    seen = 0
    for case, (jrec, raw, jpos, recs, pos, aux) in loaded.items():
        want = [r for r in jrec if r.type_name == type_name]
        got = [r for r in recs if r.type_name == type_name]
        assert sorted(r.name for r in got) == sorted(r.name for r in want)
        assert_same_records(got, want, raw, f"{case}:{type_name}")
        seen += len(want)
    assert seen, f"no file has a {type_name} node"


def test_files_match_jax_reader(ups, loaded):
    """Whole files: every record, the positions, and the aux tables as
    `export_up` stores them."""
    tool = _tool()
    for case, (jrec, raw, jpos, recs, pos, aux) in loaded.items():
        assert_same_records(recs, jrec, raw, case)
        np.testing.assert_array_equal(pos, jpos)
        assert pos.dtype == np.float32 and pos.shape == jpos.shape
        path = tool.export_up(ups[case], ups[case] + ".npz")
        want = bundle.load_aux(path)
        assert sorted(aux) == sorted(want), case
        for sec in want:
            assert_same_values(aux[sec], want[sec], f"{case}:aux/{sec}", 0)
    assert {r.type_name for v in loaded.values() for r in v[3]} == set(
        JAX_READERS) == set(reader.READERS)


def test_group_names_resolve_as_jax(loaded):
    names = {r.name for v in loaded.values() for r in v[3]}
    names |= {f"{t}{s}" for t in JAX_READERS for s in ("", "_x", "2")}
    for name in sorted(names):
        assert reader.resolve_type_name(name) == jax_resolve(name).name
    for name in ("pos", "rama", "placement", "unknown_node"):
        with pytest.raises(KeyError):
            jax_resolve(name)
        with pytest.raises(KeyError):
            reader.resolve_type_name(name)


def test_committed_up_gives_committed_bundle():
    want, want_pos = bundle.load(UBQ + ".npz")
    js, _, jpos, jaux = load_system(UBQ + ".up")
    jrec, jpos = from_jax_specs(js.specs, jpos)
    raw = {s.name: np.asarray(s.consts["raw_map"]) for s in js.specs
           if s.node_type.name == "rama_map_pot"}
    # the JAX reader exactly, in the same order
    assert [r.name for r in jrec] == [r.name for r in want]
    for j, w in zip(jrec, want):
        assert (j.type_name, j.args) == (w.type_name, w.args)
        assert_same_values(j.consts, w.consts, f"jax:{w.name}", 0)
        assert_same_values(j.params, w.params, f"jax:{w.name}", 0)
    np.testing.assert_array_equal(jpos, want_pos)
    recs, pos, aux = config.load(UBQ + ".up")
    assert_same_records(recs, want, raw, "port", rtol=0)
    np.testing.assert_array_equal(pos, want_pos)
    assert [s.decode() for s in aux["input"]["sequence"]] == jaux["sequence"]
    assert set(aux) == {"input", "pivot_moves"}


def test_from_up_matches_jax_system(ups):
    path = ups["trp_cage_full_synth"]
    system, pos = System.from_up(path, device="cpu", dtype=torch.float64)
    also, _ = System.from_config(path, device="cpu", dtype=torch.float64)
    assert [s.name for s in also.specs] == [s.name for s in system.specs]
    js, jp, jpos, _ = load_system(path)
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


def test_load_chooses_by_suffix(ups, tmp_path):
    path = ups["trp_cage_full_synth"]
    h5_copy = str(tmp_path / "copy.h5")
    shutil.copyfile(path, h5_copy)
    recs, pos, aux = config.load(h5_copy)
    npz = path[:-len(".up")] + ".npz"
    brecs, bpos, baux = config.load(npz)
    assert sorted(r.name for r in recs) == sorted(r.name for r in brecs)
    np.testing.assert_array_equal(pos, bpos)
    # the tool's synthetic bundles carry no sequence
    assert sorted(aux) == ["input", "pivot_moves"] and list(baux) == [
        "pivot_moves"]
    assert_same_values(aux["pivot_moves"], baux["pivot_moves"], "aux", 0)
    with pytest.raises(ValueError, match="not a spec bundle"):
        config.load(str(tmp_path / "x.pdb"))


def _filtered_copy(src, dst, **filters):
    """`src` with every non-scalar dataset rewritten chunked under
    `filters`, attributes kept."""
    with h5py.File(src, "r") as f, h5py.File(dst, "w") as g:
        def copy(name, obj):
            if isinstance(obj, h5py.Group):
                new = g.require_group(name)
            elif obj.shape == ():
                new = g.create_dataset(name, data=obj[()])
            else:
                new = g.create_dataset(name, data=obj[()], **filters)
            for k, v in obj.attrs.items():
                new.attrs[k] = v
        f.visititems(copy)
    return dst


def _flip_chunk_byte(path, dataset):
    """Flip one byte in the middle of the dataset's first stored chunk."""
    with h5py.File(path, "r") as f:
        info = f[dataset].id.get_chunk_info(0)
    with open(path, "r+b") as fh:
        fh.seek(info.byte_offset + info.size // 2)
        b = fh.read(1)
        fh.seek(info.byte_offset + info.size // 2)
        fh.write(bytes([b[0] ^ 0x5A]))


RAMA = "input/potential/rama_map_pot/rama_pot"


def test_filtered_copy_reads_the_same(ups, tmp_path):
    path = ups["trp_cage_full_synth"]
    want = reader.load_up(path)
    dst = _filtered_copy(path, str(tmp_path / "gz.up"), compression="gzip",
                         shuffle=True, fletcher32=True)
    with h5py.File(dst, "r") as f:
        assert f[RAMA].compression == "gzip" and f[RAMA].fletcher32
    got = reader.load_up(dst)
    assert_same_records(got[0], want[0],
                        {r.name: r.consts["raw_map"] for r in want[0]
                         if "raw_map" in r.consts}, "filtered", rtol=0)
    np.testing.assert_array_equal(got[1], want[1])
    _flip_chunk_byte(dst, RAMA)
    with pytest.raises(Exception):
        reader.load_up(dst)


def test_fletcher32_mismatch_raises(ups, tmp_path):
    path = ups["trp_cage_full_synth"]
    dst = _filtered_copy(path, str(tmp_path / "f32.up"), fletcher32=True)
    raw = reader.load_up(dst)[0]
    with h5.File(path) as f:
        np.testing.assert_array_equal(
            next(r for r in raw if r.name == "rama_map_pot")
            .consts["raw_map"], f[RAMA][()])
    _flip_chunk_byte(dst, RAMA)
    with pytest.raises(ValueError, match="Fletcher-32 checksum mismatch"):
        reader.load_up(dst)


def test_unknown_filter_raises_with_its_name(tmp_path):
    path = str(tmp_path / "lzf.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(100.0), compression="lzf")
        f.create_dataset("y", data=np.arange(100.0), scaleoffset=2)
    with h5.File(path) as f:
        with pytest.raises(h5.UnsupportedFeature, match="lzf"):
            f["x"][()]
        with pytest.raises(h5.UnsupportedFeature, match="scaleoffset"):
            f["y"][()]
