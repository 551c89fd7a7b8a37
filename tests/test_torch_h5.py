"""The port's numpy-only HDF5 writer and reader (`upside_md_torch.io.h5`)
against h5py, the library the JAX package writes and reads through:

* what the writer writes, h5py reads back exactly (float32/64,
  int32/64, fixed-length strings, 0-d and (n, 1, n_atom, 3) rows, string
  and numeric attributes, scalar and fixed-size datasets; a str attribute
  as h5py's variable-length string, a bool as h5py's enumeration), and so
  does the port's own reader;
* the file is valid after every append and flush: h5py opens it with
  every flushed row; each append grows the file by its new chunks and at
  most one new B-tree node (a leaf, once every 64 chunks, crossed here
  with 2-row chunks), never by a copy of earlier data;
* the reader reads what h5py writes by default (nested groups past one
  symbol-table node and past one group B-tree node, contiguous and
  chunked datasets with partial edge chunks, strings, scalar,
  variable-length string and numeric attributes) exactly as h5py does,
  in h5py's `visititems` order;
* the types a `.up` builder, `upside_config`'s /input/args and an edit
  of an h5py-written file need, each written by the port and by h5py and
  read back by both alike: numpy bools (h5py's int8 enumeration, as
  attributes and as datasets), str attributes (variable-length strings,
  the empty one included, one global heap for many), arrays of str, and
  string-array attributes on a group and on a dataset (`arguments`, a
  dataset's "dset:attr");
* it refuses, naming the feature, a gzip dataset whose filter pipeline
  also holds scaleoffset (gzip, shuffle and fletcher32 it reads:
  tests/test_torch_reader.py), a file written with libver="latest" and a
  variable-length dataset.
"""

import os

import h5py
import numpy as np
import pytest

from upside_md_torch.io import h5


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_writer_files_read_back_exactly(tmp_path):
    rng = np.random.default_rng(0)
    path = str(tmp_path / "w.h5")
    pos = rng.normal(size=(5, 1, 7, 3)).astype(np.float32)
    arrays = {"f64": rng.normal(size=(4, 3)), "i32":
              rng.integers(-9, 9, (6,), dtype=np.int32),
              "i64": rng.integers(0, 2 ** 40, (2, 2), dtype=np.int64),
              "seq": np.array([b"ALA", b"GLY", b"TRP"]),
              "scalar": np.float64(2.5), "iscalar": np.int32(-3)}
    attrs = {"invocation": "python -m x --flag", "n": np.int64(3),
             "x": 0.5, "vec": np.arange(3, dtype=np.float32)}
    with h5.Writer(path, attrs={"top": "root"}) as w:
        w.create_group("input")
        for k, v in arrays.items():
            w.create_dataset(f"input/{k}", v)
        w.create_group("output", attrs=attrs)
        w.create_extensible("output/pos", pos[:3], chunk_rows=2)
        w.create_extensible("output/time", np.arange(3.0), chunk_rows=4)
        w.create_extensible("output/ri", np.array([[1], [2], [3]]))
        w.append("output/pos", pos[3:])
        w.append("output/time", np.array([3.0, 4.0]))
        w.append("output/ri", np.array([[4], [5]]))
    want = {"output/pos": pos, "output/time": np.arange(5.0),
            "output/ri": np.arange(1, 6)[:, None]}
    want.update({f"input/{k}": np.asarray(v) for k, v in arrays.items()})
    with h5py.File(path, "r") as f, h5.File(path) as g:
        assert f.attrs["top"] == "root" and g.attrs["top"] == "root"
        for k, v in attrs.items():
            _same(f["output"].attrs[k], np.asarray(v))
            _same(g["output"].attrs[k], f["output"].attrs[k])
        for k, v in want.items():
            _same(f[k][()], v)
            _same(g[k][()], v)
        assert f["output/pos"].maxshape == (None, 1, 7, 3)
        assert g["output/pos"].maxshape == (None, 1, 7, 3)
        assert sorted(g["input"].keys()) == sorted(f["input"].keys())


def test_valid_after_every_flush_and_grows_by_new_chunks_only(tmp_path):
    path = str(tmp_path / "g.h5")
    rng = np.random.default_rng(1)
    rows = rng.normal(size=(143, 1, 4, 3)).astype(np.float32)
    w = h5.Writer(path)
    w.create_group("output")
    w.create_extensible("output/pos", rows[:3], chunk_rows=2)
    w.flush()
    ds = w._ext["/output/pos"]
    chunk, node = ds.chunk_bytes, ds.node_bytes
    assert chunk == 2 * 4 * 3 * 4
    n, new_nodes = 3, 0
    while n < len(rows):
        before_size, before_chunks = os.path.getsize(path), len(ds.chunks)
        w.append("output/pos", rows[n:n + 2])
        w.flush()
        n += 2
        grown = os.path.getsize(path) - before_size
        added = len(ds.chunks) - before_chunks
        # the new chunks, and a new leaf once every 64 chunks
        assert grown in (added * chunk, added * chunk + node), (n, grown)
        new_nodes += grown > added * chunk
        with h5py.File(path, "r") as f:
            _same(f["output/pos"][()], rows[:n])
    assert len(ds.chunks) == 72 and len(ds.leaves) == 2 and new_nodes == 1
    w.close()
    with h5.File(path) as g:
        _same(g["output/pos"][()], rows)


def _h5py_default_file(path):
    rng = np.random.default_rng(2)
    with h5py.File(path, "w") as f:
        f.attrs["vlen"] = "a variable-length string"
        f.attrs["num"] = 1.5
        f.attrs["arr"] = np.arange(4, dtype=np.int32)
        f.attrs["fixed"] = np.bytes_(b"fixed")
        g = f.create_group("many")
        for i in range(300):     # past one symbol node and one B-tree node
            g.create_dataset(f"d{i:03d}", data=np.array([i], np.int64))
        f.create_dataset("chunked", data=rng.normal(size=(37, 5, 3)),
                         chunks=(8, 2, 3), maxshape=(None, 5, 3))
        f.create_dataset("auto", data=rng.normal(size=(100, 1, 9, 3))
                         .astype(np.float32), chunks=True,
                         maxshape=(None, 1, 9, 3))
        f.create_dataset("contig", data=rng.integers(0, 9, (3, 4)))
        f.create_dataset("strings", data=np.array([b"MET", b"LYS"]))
        f.create_dataset("scalar", data=np.float32(7.0))
        f["nested/deeper/x"] = np.arange(5, dtype=np.uint8)
        f["nested"].attrs["note"] = np.float64(2.0)


def test_reader_reads_h5py_default_files(tmp_path):
    path = str(tmp_path / "h.h5")
    _h5py_default_file(path)
    seen_f, seen_g = [], []
    with h5py.File(path, "r") as f, h5.File(path) as g:
        f.visititems(lambda n, o: seen_f.append(n))
        g.visititems(lambda n, o: seen_g.append(n))
        assert seen_g == seen_f
        for name in seen_f:
            a, b = f[name], g[name]
            assert set(a.attrs) == set(b.attrs)
            for k in a.attrs:
                assert repr(a.attrs[k]) == repr(b.attrs[k])
            if isinstance(a, h5py.Dataset):
                assert isinstance(b, h5.Dataset)
                _same(b[()], a[()])
                assert b.maxshape == a.maxshape
            else:
                assert list(b.keys()) == list(a.keys())
        for k in f.attrs:
            assert repr(f.attrs[k]) == repr(g.attrs[k])
        assert "many/d299" in g and "many/d300" not in g


@pytest.mark.parametrize("case", ["gzip", "latest", "vlen"])
def test_reader_refuses_what_it_does_not_read(tmp_path, case):
    path = str(tmp_path / f"{case}.h5")
    if case == "latest":
        with h5py.File(path, "w", libver="latest") as f:
            f["x"] = np.arange(3)
        with pytest.raises(h5.UnsupportedFeature, match="superblock"):
            h5.File(path)
        return
    with h5py.File(path, "w") as f:
        if case == "gzip":
            f.create_dataset("x", data=np.arange(100.0), compression="gzip",
                             scaleoffset=2)
        else:
            f.create_dataset("x", data=np.array(["a", "bc"], dtype=object),
                             dtype=h5py.string_dtype())
    with h5.File(path) as g:
        with pytest.raises(h5.UnsupportedFeature,
                           match="scaleoffset" if case == "gzip"
                           else "variable-length"):
            g["x"]


UP_ATTRS = {
    "bool": {"flag": True, "off": np.False_},
    "bool_array": {"mask": np.array([True, False, True])},
    "vlen": {"fasta": "seq.fasta", "empty": "", "unicode": "\u00c5 r\u00e9s",
             **{f"s{i}": "x" * i for i in range(40)}},
    "str_array": {"names": ["ab", "c", ""]},
    "group_string_array": {"arguments": np.asarray(["pos", "rama_coord"],
                                                   dtype="S")},
    "mixed": {"arguments": np.asarray(["pos"], dtype="S"), "max_iter": 1000,
              "tol": 1e-3, "seg": np.array([2, 3], np.int32), "flag": False,
              "note": "text"},
}


@pytest.mark.parametrize("case", sorted(UP_ATTRS))
def test_up_attribute_types_round_trip(tmp_path, case):
    attrs = UP_ATTRS[case]
    mine, theirs = str(tmp_path / "mine.h5"), str(tmp_path / "theirs.h5")
    with h5.Writer(mine) as w:
        w.create_group("g", attrs)
        w.create_dataset("g/d", np.arange(3.0), attrs)
        w.create_dataset("g/b", np.array([[True], [False]]))
    with h5py.File(theirs, "w") as f:
        g = f.create_group("g")
        d = g.create_dataset("d", data=np.arange(3.0))
        g.create_dataset("b", data=np.array([[True], [False]]))
        for k, v in attrs.items():
            g.attrs[k] = v
            d.attrs[k] = v
    for path in (mine, theirs):
        with h5py.File(path, "r") as f, h5.File(path) as g:
            for name in ("g", "g/d"):
                assert sorted(f[name].attrs) == sorted(g[name].attrs)
                for k in f[name].attrs:
                    a, b = f[name].attrs[k], g[name].attrs[k]
                    assert type(a) is type(b) and repr(a) == repr(b), k
            _same(g["g/b"][()], f["g/b"][()])
            assert f["g/b"].dtype == np.bool_
    with h5py.File(mine, "r") as f, h5py.File(theirs, "r") as g:
        for name in ("g", "g/d"):
            for k in g[name].attrs:
                a, b = f[name].attrs[k], g[name].attrs[k]
                assert type(a) is type(b) and repr(a) == repr(b), k


def test_reader_refuses_other_enumerations(tmp_path):
    path = str(tmp_path / "enum.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.array([0, 1], np.int8),
                         dtype=h5py.enum_dtype({"RED": 0, "BLUE": 1},
                                               basetype="i1"))
    with h5.File(path) as g:
        with pytest.raises(h5.UnsupportedFeature, match="enumeration"):
            g["x"]
