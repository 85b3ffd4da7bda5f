"""The port's HDF5 file code (``equivariant_nn_zoo_tpu_torch/data/hdf5.py``)
held to ``h5py``, the independent witness, and to the JAX package:

- the reader on files ``h5py`` writes with its default settings: every
  integer and float dtype in either byte order, 0-d and empty datasets,
  bool, fixed- and variable-length strings in datasets and attributes, 1,
  8, 9, 33 and 200 datasets (several symbol-table nodes and B-tree
  levels), attributes spilling into continuation blocks, compact,
  contiguous and chunked layouts with deflate, shuffle and fletcher32;
  each value equal bit for bit with the type ``h5py`` gives, and the
  parsed storage equal to what ``h5py``'s low-level API reports;
- link names that are not ASCII (link messages in the root's header);
- the refusals: LZF, ``libver='latest'``, nested groups, a truncated file,
  links in a fractal heap;
- the writer: a ``hypothesis`` round trip through ``h5py``, JAX's
  ``CondensedDataset.load`` and the port's, and the port's ``dumpHDF5``
  against JAX's on the same content;
- JAX's and the port's ``CondensedDataset.load`` on the same files in the
  four path forms (file, directory, ``dir:regex``, list);
- an AST scan: no module of the port and not ``chip_smoke.py`` imports
  ``h5py``.
"""

import ast
import mmap
import os
import struct

import h5py
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from equivariant_nn_zoo_tpu.data.batch import Batch as JBatch
from equivariant_nn_zoo_tpu.data.dataset import (
    CondensedDataset as JCondensedDataset,
)
from equivariant_nn_zoo_tpu_torch.data import Batch, CondensedDataset, hdf5
from test_torch_edge_order import torch_threads_per_worker

torch_threads_per_worker()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = [f"{o}{k}{n}" for o in "<>" for k, n in
          [("i", 1), ("i", 2), ("i", 4), ("i", 8), ("u", 1), ("u", 2),
           ("u", 4), ("u", 8), ("f", 2), ("f", 4), ("f", 8)]]


def assert_same(got, want, where=""):
    """Equal bit for bit, with the type and dtype ``h5py`` gives."""
    assert type(got) is type(want), (where, type(got), type(want))
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, \
            (where, got.dtype, want.dtype, got.shape, want.shape)
        if want.dtype == object:
            assert [type(v) for v in got.flat] == \
                [type(v) for v in want.flat], where
            assert got.tolist() == want.tolist(), where
        else:
            assert got.tobytes() == want.tobytes(), where
    elif isinstance(want, np.generic):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), \
            where
    else:
        assert got == want, where


def h5py_view(path):
    """What ``h5py`` reads: ``{name: f[name][()]}`` and ``dict(f.attrs)``,
    in its key order."""
    with h5py.File(path, "r") as f:
        return ({k: f[k][()] for k in f.keys()},
                {k: f.attrs[k] for k in f.attrs.keys()})


def assert_reads_like_h5py(path):
    data, attrs = hdf5.read(path)
    want_data, want_attrs = h5py_view(path)
    assert list(data) == list(want_data)
    assert list(attrs) == list(want_attrs)
    for k in want_data:
        got = data[k]
        want = want_data[k]
        if not isinstance(want, np.ndarray):      # h5py's 0-d read
            want = np.asarray(want, dtype=got.dtype)
        assert_same(got, want, k)
    for k in want_attrs:
        assert_same(attrs[k], want_attrs[k], k)
    return data, attrs


@pytest.mark.parametrize("dtype", DTYPES)
def test_reads_every_numeric_dtype(tmp_path, dtype):
    rng = np.random.default_rng(len(dtype) + ord(dtype[0]) + ord(dtype[1]))
    dt = np.dtype(dtype)
    if dt.kind == "f":
        values = rng.normal(size=(7, 3)) * 100
    else:
        info = np.iinfo(dt)
        values = rng.integers(info.min, info.max, size=(7, 3),
                              dtype=dt.newbyteorder("="), endpoint=True)
    path = tmp_path / "x.h5"
    with h5py.File(path, "w") as f:
        f["x"] = values.astype(dt)
        f["scalar"] = values.astype(dt)[0, 0]
        f["empty"] = np.zeros((0, 3), dt)
        f.attrs["array"] = values.astype(dt)[0]
        f.attrs["scalar"] = values.astype(dt)[1, 1]
    data, _ = assert_reads_like_h5py(path)
    assert data["x"].dtype == dt and data["scalar"].shape == ()


def test_reads_bool_strings_and_attribute_kinds(tmp_path):
    path = tmp_path / "x.h5"
    with h5py.File(path, "w") as f:
        f["bool"] = np.array([[True], [False], [True]])
        f["fixed"] = np.array([b"ab", b"cde", b""])
        f["vlen"] = np.array(["x", "yzé", ""],
                             dtype=h5py.string_dtype())
        f["vlen_ascii"] = np.array([b"q", b"rs"],
                                   dtype=h5py.string_dtype("ascii"))
        f.attrs["pos"] = ("node", "1x1o")
        f.attrs["name"] = "héllo"
        f.attrs["int"] = 5
        f.attrs["float"] = 2.5
        f.attrs["bool"] = True
        f.attrs["bools"] = np.array([True, False])
        f.attrs["fixed"] = np.bytes_(b"xyz")
        f.attrs["fixed_array"] = np.array([b"a", b"bc"])
        f.attrs["ascii_array"] = np.array(
            [b"q", b"rs"], dtype=h5py.string_dtype("ascii"))
        f.attrs["empty_str"] = ""
    data, attrs = assert_reads_like_h5py(path)
    assert data["bool"].dtype == bool
    assert attrs["pos"].tolist() == ["node", "1x1o"]
    assert type(attrs["name"]) is str and type(attrs["int"]) is np.int64


def root_btree_level(path):
    with open(path, "rb") as f, \
            mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        reader = hdf5._Reader(str(path), mm)
        _, msgs = reader.root()
        q = next(m[1] for m in msgs if m[0] == hdf5.SYMBOL_TABLE)
        btree = reader.uint(q, reader.O)
        return mm[btree + 5], any(m[0] == hdf5.CONTINUATION for m in msgs)


@pytest.mark.parametrize("n", [1, 8, 9, 33, 200])
def test_reads_many_datasets_and_attributes(tmp_path, n):
    """More than 2K = 8 links split the root's symbol table over several
    nodes; 200 need an internal B-tree level.  ``dumpHDF5`` adds every
    attribute after every dataset, so the root header grows into
    continuation blocks."""
    path = tmp_path / "x.h5"
    rng = np.random.default_rng(n)
    with h5py.File(path, "w") as f:
        for i in rng.permutation(n):
            f[f"key{i}"] = rng.normal(size=(int(i) % 5 + 1, 3))
        for i in range(n):
            f.attrs[f"key{i}"] = ("node", f"{i}x0e")
    assert_reads_like_h5py(path)
    level, continued = root_btree_level(path)
    assert level == (1 if n == 200 else 0)
    assert continued


LAYOUTS = [
    dict(),
    dict(chunks=(7, 3)),
    dict(chunks=(7, 3), compression="gzip"),
    dict(chunks=(5, 4), compression="gzip", compression_opts=9,
         shuffle=True),
    dict(chunks=(16, 1), shuffle=True, fletcher32=True),
    dict(chunks=(7, 3), compression="gzip", shuffle=True, fletcher32=True),
    dict(chunks=True, maxshape=(None, 10), compression="gzip"),
    "compact",
]


@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
@pytest.mark.parametrize("dtype", ["<f8", ">i4", "<u2", "?"])
def test_reads_layouts_and_filters(tmp_path, layout, dtype):
    """Chunked data (edge chunks included) through the chunk B-tree and the
    filters, and the compact layout; the parsed storage agrees with
    ``h5py``'s low-level API."""
    path = tmp_path / "x.h5"
    rng = np.random.default_rng(3)
    values = (rng.normal(size=(101, 10)) * 50).astype(dtype)
    with h5py.File(path, "w") as f:
        if layout == "compact":
            values = values[:4]
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            tid = h5py.h5t.py_create(values.dtype)
            space = h5py.h5s.create_simple(values.shape)
            h5py.h5d.create(f.id, b"x", tid, space, dcpl).write(
                h5py.h5s.ALL, h5py.h5s.ALL, values)
        else:
            f.create_dataset("x", data=values, **layout)
    data, _ = assert_reads_like_h5py(path)
    np.testing.assert_array_equal(data["x"], values)
    with h5py.File(path, "r") as f, open(path, "rb") as fh, \
            mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        dsid = f["x"].id
        reader = hdf5._Reader(str(path), mm)
        links, _ = reader.root()
        msgs = {m[0]: m for m in reader.messages(links["x"], "x")}
        q = msgs[hdf5.LAYOUT][1]
        assert mm[q + 1] == dsid.get_create_plist().get_layout()
        if layout == {}:
            assert reader.uint(q + 2, reader.O) == dsid.get_offset()
            assert reader.uint(q + 2 + reader.O, reader.L) == \
                dsid.get_storage_size()
        elif layout != "compact":
            chunks = list(reader.chunk_node(reader.uint(q + 3, reader.O), 2,
                                            "x", 0))
            assert len(chunks) == dsid.get_num_chunks()
            for i in range(dsid.get_num_chunks()):
                info = dsid.get_chunk_info(i)
                assert (tuple(info.chunk_offset), info.byte_offset,
                        info.size, info.filter_mask) in chunks


def test_reads_names_that_are_not_ascii(tmp_path):
    """HDF5 keeps links whose names are not ASCII as link messages in the
    root group's header (a new-style group), even at ``libver``
    earliest."""
    path = tmp_path / "x.h5"
    with h5py.File(path, "w") as f:
        f["dé"] = np.arange(3)
        f["pos"] = np.ones((2, 3), np.float32)
        f.attrs["é"] = ("node", "1x0e")
        f.attrs["pos"] = ("node", "1x1o")
    data, _ = assert_reads_like_h5py(path)
    assert list(data) == ["dé", "pos"]


def test_fletcher32_matches_hdf5_on_odd_lengths(tmp_path):
    """Odd byte counts (a uint8 chunk of 13 bytes) and more than one block
    of 360 words."""
    path = tmp_path / "x.h5"
    values = np.arange(2000, dtype=np.uint8).reshape(-1) * 7
    with h5py.File(path, "w") as f:
        f.create_dataset("odd", data=values[:1001], chunks=(13,),
                         fletcher32=True)
        f.create_dataset("long", data=values, chunks=(2000,),
                         fletcher32=True)
    assert_reads_like_h5py(path)


def test_refuses_what_it_does_not_read(tmp_path):
    lzf, latest, nested, cut, dense = (tmp_path / n for n in (
        "lzf.h5", "latest.h5", "nested.h5", "cut.h5", "dense.h5"))
    with h5py.File(lzf, "w") as f:
        f.create_dataset("x", data=np.arange(100), compression="lzf")
    with h5py.File(latest, "w", libver="latest") as f:
        f["x"] = np.arange(3)
    with h5py.File(nested, "w") as f:
        f["g/x"] = np.arange(3)
    with h5py.File(cut, "w") as f:
        f["x"] = np.arange(1000)
    with open(cut, "r+b") as f:
        f.truncate(os.path.getsize(cut) - 100)
    with h5py.File(dense, "w") as f:           # past 8 links: a fractal heap
        for i in range(12):
            f[f"é{i}"] = np.arange(3)
    for path, what in ((lzf, "'x': filter 32000 \\(LZF\\)"),
                       (latest, "superblock version 3 .*libver='latest'"),
                       (nested, "'g': a nested group"),
                       (cut, "the file: .*truncated"),
                       (dense, "dense link storage")):
        with pytest.raises(ValueError, match=f"{path.name}: .*{what}"):
            hdf5.read(path)
        with pytest.raises(ValueError, match=path.name):
            CondensedDataset.load(str(path))
    empty = tmp_path / "empty.h5"
    empty.write_bytes(b"")
    with pytest.raises(ValueError, match="not an HDF5 file"):
        hdf5.read(empty)


def test_writer_refuses_object_and_text_arrays(tmp_path):
    for data, attrs in (({"x": np.array([1, "a"], dtype=object)}, {}),
                        ({"x": np.array(["a", "b"])}, {}),
                        ({}, {"a": b"bytes"}),
                        ({}, {"a": ("node", 3)})):
        with pytest.raises(ValueError, match="cannot write"):
            hdf5.write(tmp_path / "x.h5", data, attrs)


# ------------------------------------------------------------ the writer

NAMES = st.text(st.characters(codec="utf-8", exclude_characters="\0/.",
                              exclude_categories=("Cs",)),
                min_size=1, max_size=6)
WRITE_DTYPES = ["?", "<i1", "<i2", "<i4", "<i8", "<u1", "<u2", "<u4",
                "<u8", "<f2", "<f4", "<f8", ">i4", ">f8"]


@st.composite
def contents(draw):
    names = draw(st.lists(NAMES, min_size=1, max_size=12, unique=True))
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    data = {}
    for name in names:
        dt = np.dtype(draw(st.sampled_from(WRITE_DTYPES)))
        shape = tuple(draw(st.lists(st.integers(0, 4), max_size=3)))
        if dt.kind == "f":
            v = rng.normal(size=shape) * 1e3
        elif dt.kind == "b":
            v = rng.random(shape) < 0.5
        else:
            info = np.iinfo(dt)
            v = rng.integers(info.min, info.max, size=shape,
                             dtype=dt.newbyteorder("="), endpoint=True)
        data[name] = np.asarray(v).astype(dt)
    attrs = {}
    for name in draw(st.lists(NAMES, max_size=10, unique=True)):
        attrs[name] = draw(st.one_of(
            st.lists(st.text(max_size=8).filter(
                lambda s: "\0" not in s and not any(
                    0xD800 <= ord(c) <= 0xDFFF for c in s)),
                min_size=1, max_size=4).map(tuple),
            st.integers(-2**63, 2**63 - 1),
            st.floats(allow_nan=False),
            st.text(max_size=8).filter(lambda s: "\0" not in s and not any(
                0xD800 <= ord(c) <= 0xDFFF for c in s))))
    return data, attrs


def expected_h5py(data, attrs):
    """What ``h5py`` gives back for content ``h5py`` writes: little-endian
    arrays, numpy scalars for numbers, object arrays of ``str``."""
    want_data = {k: np.asarray(v, v.dtype.newbyteorder("<"))
                 if v.dtype.kind != "b" else v for k, v in data.items()}
    want_attrs = {}
    for k, v in attrs.items():
        if isinstance(v, tuple):
            want_attrs[k] = np.array(list(v) + [None], dtype=object)[:-1]
        elif isinstance(v, str):
            want_attrs[k] = v
        else:
            want_attrs[k] = np.asarray(v)[()]
    return want_data, want_attrs


@settings(max_examples=40, deadline=None, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(content=contents())
def test_writer_round_trip(tmp_path, content):
    """A file the writer makes reads back through ``h5py``, the port's
    reader and both packages' ``CondensedDataset.load`` to what was
    written."""
    data, attrs = content
    path = tmp_path / "w.h5"
    hdf5.write(path, data, attrs)
    want_data, want_attrs = expected_h5py(data, attrs)
    order = sorted(data, key=lambda k: k.encode())
    got_data, got_attrs = h5py_view(path)
    assert list(got_data) == order
    for k in order:
        assert_same(np.asarray(got_data[k]), want_data[k], k)
    for k in want_attrs:
        assert_same(got_attrs[k], want_attrs[k], k)
    data2, attrs2 = hdf5.read(path)
    assert list(data2) == order
    for k in order:
        assert_same(data2[k], want_data[k], k)
    assert set(attrs2) == set(want_attrs)
    for k in want_attrs:
        assert_same(attrs2[k], want_attrs[k], k)
    # JAX's load slices every dataset (``f[key][:]``), which h5py refuses
    # on a 0-d one
    loadable = tmp_path / "loadable.h5"
    hdf5.write(loadable, {k: v for k, v in data.items() if v.ndim}, attrs)
    assert_loads_equal(CondensedDataset.load(str(loadable)),
                       JCondensedDataset.load(str(loadable)))


def assert_loads_equal(got, want):
    """Two ``CondensedDataset.load`` results: arrays bit for bit with equal
    dtypes, attributes of equal value and type, in the same order."""
    (gd, ga), (wd, wa) = got, want
    assert type(gd) is type(wd)
    if isinstance(wd, list):
        assert len(gd) == len(wd)
    else:
        gd, wd = [gd], [wd]
    for g, w in zip(gd, wd):
        assert list(g) == list(w)
        for k in w:
            assert_same(g[k], w[k], k)
    assert list(ga) == list(wa)
    for k in wa:
        assert type(ga[k]) is type(wa[k]), k
        if isinstance(wa[k], tuple):
            assert ga[k] == wa[k], k
        else:
            assert_same(ga[k], wa[k], k)


def dump_pair(tmp_path, tag, seed, scalars=False):
    """The same content through JAX's ``dumpHDF5`` (``h5py``) and the
    port's (``hdf5.write``); with ``scalars``, a ``str`` and an ``int``
    attribute beside the ``(is_per, irreps)`` pairs (which a dataset's
    constructor refuses)."""
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(5):
        n = int(rng.integers(3, 9))
        items.append({"pos": rng.normal(size=(n, 3)).astype(np.float32),
                      "species": rng.integers(0, 5, size=(n, 1)),
                      "flag": rng.random((n, 1)) < 0.5,
                      "y": rng.normal(size=(1, 2)),
                      "edge_index": rng.integers(0, n, size=(2, 4)),
                      "_n_nodes": n})
    attrs = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
             "flag": ("node", "1x0e"), "y": ("graph", 2),
             "edge_index": ("edge", "1x0e"), "_n_nodes": ("graph", "1x0e")}
    paths = []
    for name, cls in (("jax", JBatch), ("port", Batch)):
        batch = cls.from_data_list([dict(it) for it in items], attrs)
        if scalars:
            batch.attrs["note"] = "hé"
            batch.attrs["count"] = 3
        path = tmp_path / name / f"{tag}.hdf5"
        path.parent.mkdir(exist_ok=True)
        batch.dumpHDF5(str(path))
        paths.append(str(path))
    return paths


def test_dump_matches_jax_dump(tmp_path):
    """A file the port's ``dumpHDF5`` writes and one JAX's writes from the
    same content load identically through ``h5py``, JAX's
    ``CondensedDataset.load`` and the port's."""
    jax_file, port_file = dump_pair(tmp_path, "a", 0, scalars=True)
    (jd, ja), (pd, pa) = h5py_view(jax_file), h5py_view(port_file)
    assert list(jd) == list(pd) and list(ja) == list(pa)
    assert "_node_segment" not in pd and "_edge_segment" not in pd
    for k in jd:
        assert_same(pd[k], jd[k], k)
    for k in ja:
        assert_same(pa[k], ja[k], k)
    for load in (JCondensedDataset.load, CondensedDataset.load):
        assert_loads_equal(load(port_file), load(jax_file))
    assert_loads_equal(CondensedDataset.load(jax_file),
                       JCondensedDataset.load(jax_file))


def test_load_matches_jax_in_every_path_form(tmp_path):
    """File, directory, ``dir:regex`` and a list of paths: JAX's and the
    port's ``CondensedDataset.load`` agree on the files JAX writes and on
    the files the port writes, and the datasets built on them agree."""
    for seed, tag in enumerate(("a", "b", "c")):
        dump_pair(tmp_path, tag, seed)
    for side in ("jax", "port"):
        d = tmp_path / side
        forms = [str(d / "a.hdf5"), str(d), f"{d}:.*[ab].hdf5",
                 [str(d / "c.hdf5"), f"{d}:.*a.hdf5"]]
        for path in forms:
            assert_loads_equal(CondensedDataset.load(path),
                               JCondensedDataset.load(path))
            mine = CondensedDataset(path=path)
            theirs = JCondensedDataset(path=path)
            assert list(mine.data) == list(theirs.data)
            for k in theirs.data:
                assert_same(mine.data[k], np.asarray(theirs.data[k]), k)
            assert mine.attrs == theirs.attrs


def test_large_file_reads_by_offset(tmp_path):
    """A contiguous dataset of 8 MB is one ``frombuffer`` at its offset:
    the read is equal and quick."""
    import time

    rng = np.random.default_rng(0)
    data = {"pos": rng.normal(size=(700_000, 3)).astype(np.float32),
            "_n_nodes": rng.integers(3, 30, size=(30_000, 1))}
    path = tmp_path / "big.h5"
    hdf5.write(path, data, {"pos": ("node", "1x1o")})
    t0 = time.perf_counter()
    got, _ = hdf5.read(path)
    assert time.perf_counter() - t0 < 5.0
    for k in data:
        assert_same(got[k], data[k], k)


def test_no_port_module_imports_h5py():
    """No module of the port and not ``chip_smoke.py`` imports ``h5py``,
    at module level or inside a function."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(
            REPO, "equivariant_nn_zoo_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = []
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            if any(n.split(".")[0] == "h5py" for n in names):
                offenders.append(f"{os.path.relpath(path, REPO)}:"
                                 f"{node.lineno}")
    assert not offenders, offenders


def test_superblock_end_of_file_is_the_length(tmp_path):
    path = tmp_path / "x.h5"
    hdf5.write(path, {"x": np.arange(5)}, {"x": ("node", "1x0e")})
    raw = path.read_bytes()
    eof, = struct.unpack_from("<Q", raw, 24 + 16)
    assert eof == len(raw)


def test_reads_a_user_block_and_writes_no_datasets(tmp_path):
    """A file with a 512-byte user block (the superblock and its base
    address after it), and a file of attributes only."""
    path = tmp_path / "ub.h5"
    with h5py.File(path, "w", userblock_size=512) as f:
        f["x"] = np.arange(6.0).reshape(2, 3)
        f.attrs["x"] = ("node", "1x1o")
    assert_reads_like_h5py(path)
    empty = tmp_path / "attrs_only.h5"
    hdf5.write(empty, {}, {"note": "only attributes", "n": 3})
    data, attrs = assert_reads_like_h5py(empty)
    assert data == {} and attrs["note"] == "only attributes"
