"""``isochrones_torch.hdf5`` and ``catalog.read_hdf_table`` against h5py (3.14,
HDF5 1.14 here) on the CPU:

- the reader on files that h5py writes: every supported datatype class
  (integers of both byte orders, floats, bitfields, fixed and
  variable-length strings, compounds with array members, enums and h5py's
  boolean enum), scalar, simple, empty and null dataspaces, nested groups,
  a group past one B-tree node, attributes past one header block
  (continuation messages), compact, contiguous and chunked layouts
  (deflate, shuffle, a fill value, edge chunks): equal to h5py's values,
  dtype and Python type included;
- the writer: h5py reads every file it writes equal to the tree, and
  writes into it (appends) as into its own; a ``hypothesis`` round trip;
- each unsupported feature raises ``ValueError`` naming it;
- pandas' ``fixed`` and ``table`` layouts (``tests/pandas_hdf.py``, written
  with h5py as ``pandas/io/pytables.py`` lays them out) read to the columns
  that ``read_csv`` gives for the frame's CSV; the layouts that
  ``chip_smoke.pandas_frame_tree`` writes without h5py read the same.
"""

import os

import h5py
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import pandas_hdf
from chip_smoke import pandas_frame_tree
from isochrones_torch import hdf5
from isochrones_torch.catalog import read_csv, read_hdf_table, read_table


def _h5py_items(path):
    """Every dataset (its value) and attribute (``<path>@<name>``) of a file
    as h5py reads it; ``Empty`` attributes as None."""
    out = {}

    def attrs(name, obj):
        for k, v in obj.attrs.items():
            out[f"{name}@{k}"] = None if isinstance(v, h5py.Empty) else v

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            out[name] = obj[()]
        attrs(name, obj)

    with h5py.File(path, "r") as f:
        attrs("", f)
        f.visititems(visit)
    return out


def _port_items(path):
    """The same from ``isochrones_torch.hdf5.File``."""
    out = {}

    def walk(group, prefix):
        for k, v in group.attrs.items():
            out[f"{prefix}@{k}"] = v
        for name in group:
            path = f"{prefix}/{name}".lstrip("/")
            node = group.node(name)
            if isinstance(node, hdf5.Group):
                walk(node, path)
            else:
                value = node.read()
                out[path] = value[()] if value.shape == () else value
                for k, v in node.attrs.items():
                    out[f"{path}@{k}"] = v

    walk(hdf5.File(path), "")
    return out


def _equal(a, b):
    """Equal values, NaN equal to NaN, field by field for records."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.names:
        return a.dtype == b.dtype and all(_equal(a[n], b[n]) for n in a.dtype.names)
    return np.array_equal(a, b, equal_nan=a.dtype.kind in "fc")


def _assert_same(got, ref):
    assert sorted(got) == sorted(ref)
    for key, want in ref.items():
        value = got[key]
        assert type(value) is type(want), (key, type(value), type(want))
        if isinstance(want, np.ndarray):
            assert value.dtype == want.dtype and value.shape == want.shape, key
            assert value.tolist() == want.tolist() if want.dtype == object else _equal(value, want), key
        elif isinstance(want, np.void):
            assert value.dtype == want.dtype and _equal(value, want), key
        else:
            assert _equal(value, want), key


# ------------------------------------------------------------------ the reader
def _numbers(f):
    rng = np.random.default_rng(0)
    for dt in ("<i1", "<u2", "<i4", "<u8", ">i8", ">u4", "<f2", "<f4", ">f8", "<f8"):
        f[f"n/{dt[1:]}_{'be' if dt[0] == '>' else 'le'}"] = (rng.normal(size=(3, 4)) * 100).astype(dt)
    f["n/bool"] = np.array([True, False, True])
    f["n/nan"] = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0])


def _strings(f):
    f["s/fixed"] = np.array([b"ab", b"cde", b""])
    f["s/vlen"] = np.array(["héllo", "x", ""], dtype=h5py.string_dtype())
    f["s/vlen_ascii"] = np.array([b"a", b"bb"], dtype=h5py.string_dtype("ascii"))
    f["s"].attrs["text"] = "naïve"
    f["s"].attrs["empty_text"] = ""
    f["s"].attrs["texts"] = ["a", "bc", ""]
    f["s"].attrs["fixed"] = np.bytes_(b"fixed")
    f["s"].attrs["null"] = h5py.Empty("f8")


def _compound(f):
    dt = np.dtype([("name", "S32"), ("band", "S16"), ("x", "<f8"), ("n", ">i4"), ("ok", "?"), ("v", "<f4", (2, 3))])
    rec = np.zeros(4, dtype=dt)
    rec["name"], rec["x"], rec["ok"] = [b"a", b"bb", b"", b"d"], [1.0, np.nan, 3.0, 4.0], [True, False, True, False]
    rec["v"] = np.arange(24).reshape(4, 2, 3)
    f["c/rec"] = rec
    f["c/aligned"] = np.zeros(2, dtype=np.dtype([("a", "u1"), ("b", "<f8")], align=True))
    f["c"].attrs["rec"] = rec[:2]
    f["c"].attrs["one"] = rec[0]


def _enums(f):
    f.create_dataset("e/colour", data=np.array([0, 2, 1], dtype="i2"),
                     dtype=h5py.enum_dtype({"RED": 0, "GREEN": 1, "BLUE": 2}, basetype="i2"))
    f["e"].attrs["flag"] = True
    f["e"].attrs["flags"] = np.array([True, False])
    pandas_hdf.set_attr(f["e"], "bitfield", True)


def _spaces(f):
    f["d/scalar"] = 3.5
    f["d/scalar_int"] = np.int64(-7)
    f["d/empty"] = np.zeros((0, 4))
    f["d/empty_str"] = np.zeros(0, dtype="S3")
    f["d"].attrs["int"] = 5
    f["d"].attrs["float"] = 2.5
    f["d"].attrs["arr"] = np.arange(6.0).reshape(2, 3)


def _layouts(f):
    rng = np.random.default_rng(1)
    data = rng.normal(size=(50, 7))
    f.create_dataset("l/chunked", data=data, chunks=(8, 3))
    f.create_dataset("l/deflate", data=data, chunks=(16, 7), compression="gzip", compression_opts=9)
    f.create_dataset("l/shuffle", data=data, chunks=(7, 2), compression="gzip", shuffle=True)
    f.create_dataset("l/shuffle_only", data=np.arange(99, dtype="i4"), chunks=(10,), shuffle=True)
    f.create_dataset("l/filled", data=np.arange(12.0).reshape(3, 4), chunks=(2, 2), maxshape=(None, 4),
                     fillvalue=-1.0)
    f["l/filled"].resize((7, 4))
    f.create_dataset("l/unwritten", shape=(5,), dtype="f4", fillvalue=7.0)
    f.create_dataset("l/unwritten_chunked", shape=(5, 2), dtype="i2", chunks=(2, 2), fillvalue=3)
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    sid = h5py.h5s.create_simple((4,))
    h5py.h5d.create(f.id, b"l/compact", h5py.h5t.STD_I32BE, sid, dcpl=dcpl).write(
        h5py.h5s.ALL, h5py.h5s.ALL, np.arange(4, dtype=">i4"))
    f.create_dataset("l/vlen_chunked", data=np.array(["a", "bcd", "ef"] * 5, dtype=h5py.string_dtype()),
                     chunks=(4,), compression="gzip")


def _groups(f):
    for i in range(300):  # 38 symbol table nodes: a B-tree past one node
        f.create_group(f"many/g{i:03d}")
    f["deep/a/b/c/x"] = np.arange(3)
    f.create_group("deep/empty")
    for i in range(60):  # past the first header block: continuation messages
        f["deep"].attrs[f"attr{i:02d}"] = "x" * (3 * i)


@pytest.mark.parametrize("maker", [_numbers, _strings, _compound, _enums, _spaces, _layouts, _groups],
                         ids=lambda m: m.__name__.strip("_"))
def test_reader_matches_h5py(tmp_path, maker):
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w") as f:
        maker(f)
    _assert_same(_port_items(path), _h5py_items(path))
    with hdf5.File(path) as f:
        assert isinstance(f, hdf5.Group) and sorted(f.keys()) == sorted(h5py.File(path, "r").keys())


def test_reader_tree_and_errors(tmp_path):
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w") as f:
        _groups(f)
        f["top"] = np.arange(4)
    f = hdf5.File(path)
    assert "deep/a/b/c/x" in f and "deep/a/missing" not in f and "top/x" not in f
    assert isinstance(f["deep/a"], hdf5.Group) and f["deep"]["a/b/c/x"].tolist() == [0, 1, 2]
    assert list(f["many"])[:3] == ["g000", "g001", "g002"] and len(f["many"]) == 300
    node = f.node("top")
    assert isinstance(node, hdf5.Dataset) and node.shape == (4,) and node.dtype == np.dtype("<i8")
    with pytest.raises(KeyError):
        f["nope"]
    tree = hdf5.read(path)
    assert isinstance(tree, hdf5.Tree) and tree.get_path("deep/a/b/c/x").tolist() == [0, 1, 2]
    assert tree.get_path("deep/none") is None and tree["deep"].attrs["attr59"] == "x" * 177


# ------------------------------------------------------------------ the writer
def _tree():
    rng = np.random.default_rng(2)
    rec = np.zeros(3, dtype=[("name", "S32"), ("band", "S16"), ("mag", "<f8"), ("relative", "?")])
    rec["name"], rec["mag"], rec["relative"] = [b"a", b"b", b"c"], [1.5, np.nan, 2.0], [True, False, True]
    t = hdf5.Tree(attrs={"ic_type": "MIST_Isochrone", "N": 2, "use_emcee": False, "x": 1.5, "none": None,
                         "empty": "", "bands": ["J", "H"], "fixed": np.bytes_(b"abc"), "i4": np.int32(-3),
                         "arr": np.arange(3.0), "flags": np.array([True, False])})
    t.require("fits/a/samples")["values"] = rng.normal(size=(40, 6))
    t["fits"]["a"]["samples"].attrs["columns"] = '["eep", "age"]'
    t.require("obs")["values"] = rec
    t["obs"].attrs["limits"] = '{"0_0": {"logg": [3.5, null]}}'
    t["scalar"] = np.float32(2.5)
    t["empty"] = np.zeros((0, 3))
    t["big_endian"] = np.arange(5, dtype=">i2")
    t["strings"] = np.array(["héllo", "", "x"], dtype=object)
    t["data"] = hdf5.Data(np.arange(10.0).reshape(5, 2), {"kind": np.bytes_(b"float"), "transposed": True})
    t["deflated"] = hdf5.Data(rec, {"NROWS": np.int64(3)}, deflate=6)
    for i in range(40):
        t.require("many")[f"d{i:02d}"] = np.full(i % 3 + 1, i)
    return t


def _tree_items(tree, prefix=""):
    out = {f"{prefix}@{k}": v for k, v in tree.attrs.items()}
    for name, v in tree.items():
        path = f"{prefix}/{name}".lstrip("/")
        if isinstance(v, hdf5.Tree):
            out.update(_tree_items(v, path))
            continue
        if isinstance(v, hdf5.Data):
            out.update({f"{path}@{k}": a for k, a in v.attrs.items()})
            v = v.array
        out[path] = np.asarray(v)
    return out


def test_writer_read_by_h5py(tmp_path):
    path = str(tmp_path / "w.h5")
    tree = _tree()
    hdf5.write(path, tree)
    assert os.listdir(tmp_path) == ["w.h5"]  # the temporary file was renamed into place
    got, want = _h5py_items(path), _tree_items(tree)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        g = got[key]
        if value is None:
            assert g is None
        elif isinstance(value, str):
            assert type(g) is str and g == value, key
        elif isinstance(value, bool):
            assert type(g) is np.bool_ and g == value, key
        elif isinstance(value, int):
            assert type(g) is np.int64 and g == value, key
        elif isinstance(value, list):
            assert list(g) == value, key
        elif np.asarray(value).dtype == object:
            assert [s.decode() for s in np.asarray(g).ravel()] == list(value.ravel()), key
        else:
            value = np.asarray(value)
            assert np.asarray(g).dtype == value.dtype and _equal(g, value), key
    with h5py.File(path, "r") as f:
        assert f["deflated"].compression == "gzip" and f["deflated"].shuffle
        assert f["data"].attrs["transposed"] and f.attrs["use_emcee"] is np.False_
    # h5py writes into the file (groups, attributes, deletions), and the reader follows
    with h5py.File(path, "a") as f:
        f["added/x"] = np.arange(3)
        f.attrs["later"] = "yes"
        del f["scalar"]
        for i in range(50):
            f.create_group(f"many/z{i:02d}")
    again = hdf5.read(path)
    assert again["added"]["x"].tolist() == [0, 1, 2] and again.attrs["later"] == "yes"
    assert "scalar" not in again and len(again["many"]) == 90
    # read, change, write again: the append of the port's results code
    again["fits"].pop("a")
    hdf5.write(path, again)
    _assert_same(_port_items(path), _h5py_items(path))
    with pytest.raises(TypeError, match="hdf5.Tree"):
        hdf5.write(path, {"x": np.arange(2)})
    with pytest.raises(TypeError, match="object"):
        hdf5.write(path, hdf5.Tree({"x": np.array([None, 1], dtype=object)}))
    with pytest.raises(ValueError, match="NUL"):
        hdf5.write(path, hdf5.Tree(attrs={"x": "a\0b"}))


_DTYPES = st.sampled_from(["<i1", "<u1", "<i2", ">i4", "<u8", "<f2", "<f4", ">f8", "<f8", "?", "S4"])
_NAMES = st.text(alphabet="abcdefghij_0123456789", min_size=1, max_size=8)


@st.composite
def _arrays(draw):
    dt = np.dtype(draw(_DTYPES))
    shape = tuple(draw(st.lists(st.integers(0, 4), max_size=3)))
    n = int(np.prod(shape))
    raw = draw(st.binary(min_size=n * dt.itemsize, max_size=n * dt.itemsize))
    arr = np.frombuffer(raw, dtype=np.uint8 if dt.kind == "b" else dt, count=n).reshape(shape)
    return (arr % 2).astype(bool) if dt.kind == "b" else arr


_ATTRS = st.one_of(st.text(st.characters(blacklist_characters="\0"), max_size=20), st.integers(-2 ** 63, 2 ** 63 - 1), st.booleans(),
                   st.floats(allow_nan=False), _arrays())


@st.composite
def _trees(draw, depth=0):
    t = hdf5.Tree(attrs=draw(st.dictionaries(_NAMES, _ATTRS, max_size=4)))
    for name in draw(st.lists(_NAMES, max_size=4, unique=True)):
        t[name] = draw(_trees(depth + 1)) if depth < 2 and draw(st.booleans()) else draw(_arrays())
    return t


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(tree=_trees())
def test_round_trip_hypothesis(tmp_path, tree):
    path = str(tmp_path / "rt.h5")
    hdf5.write(path, tree)
    ref = _h5py_items(path)
    _assert_same(_port_items(path), ref)
    want = _tree_items(tree)
    assert sorted(ref) == sorted(want)
    for key, value in want.items():
        assert _equal(ref[key], value), key


# ------------------------------------------------------------- what it refuses
def _latest(path):
    with h5py.File(path, "w", libver="latest") as f:
        f["x"] = np.arange(3)


def _lzf(path):
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(100.0), chunks=(10,), compression="lzf")


def _fletcher(path):
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(100.0), chunks=(10,), fletcher32=True)


def _vlen_ints(path):
    with h5py.File(path, "w") as f:
        f.create_dataset("x", shape=(2,), dtype=h5py.vlen_dtype("i4"))


def _opaque(path):
    with h5py.File(path, "w") as f:
        f["x"] = np.void(b"abcd")


def _reference(path):
    with h5py.File(path, "w") as f:
        f["a"] = 1
        f.attrs["ref"] = f["a"].ref


def _dense_attrs(path):
    # dense attribute storage comes with version-2 object headers
    with h5py.File(path, "w", libver=("earliest", "v108")) as f:
        g = f.create_group("g", track_order=True)
        for i in range(12):
            g.attrs[f"a{i}"] = np.zeros(1000)


def _new_style_group(path):
    with h5py.File(path, "w", libver=("earliest", "v108"), track_order=True) as f:
        f.create_group("g", track_order=True)["x"] = 1


def _not_hdf5(path):
    with open(path, "w") as f:
        f.write("a,b\n1,2\n")


@pytest.mark.parametrize("maker, what", [
    (_latest, "superblock version 3"),
    (_lzf, "lzf filter"),
    (_fletcher, "fletcher32 filter"),
    (_vlen_ints, "variable-length sequence"),
    (_opaque, "opaque datatype"),
    (_reference, "reference datatype"),
    (_dense_attrs, "version-2 object header"),
    (_new_style_group, "version-2 object header|new-style group"),
    (_not_hdf5, "without the HDF5 signature"),
], ids=lambda v: getattr(v, "__name__", "").strip("_") or None)
def test_unsupported_features_raise(tmp_path, maker, what):
    path = str(tmp_path / "u.h5")
    maker(path)
    with pytest.raises(ValueError, match=what) as err:
        hdf5.read(path)
    assert path in str(err.value)


# ------------------------------------------------------- pandas' HDF layouts
def _frame_columns(n=9, seed=3):
    rng = np.random.default_rng(seed)
    cols = {"J_mag": rng.normal(10, 1, n), "J_mag_unc": np.full(n, 0.02), "K_mag": rng.normal(9, 1, n),
            "K_mag_unc": np.full(n, 0.03), "parallax": rng.uniform(1, 5, n), "parallax_unc": np.full(n, 0.05),
            "count": np.arange(n, dtype=np.int64) * 3}
    cols["J_mag"][2] = np.nan
    return cols


def _csv_columns(tmp_path, cols):
    path = str(tmp_path / "frame.csv")
    import pandas as pd

    pd.DataFrame(cols).to_csv(path, index=False)
    return read_csv(path)


@pytest.mark.parametrize("layout", ["fixed", "fixed_deflate", "fixed_string_index", "table", "table_deflate",
                                    "table_data_columns", "table_string_index"])
def test_pandas_layouts_read_as_csv(tmp_path, layout):
    cols = _frame_columns()
    n = len(cols["J_mag"])
    index = [f"star{i}" for i in range(n)] if "string_index" in layout else None
    path = str(tmp_path / "frame.h5")
    kw = dict(index=index, complevel=6 if "deflate" in layout else None)
    if layout.startswith("fixed"):
        pandas_hdf.write_fixed(path, cols, **kw)
    else:
        pandas_hdf.write_table(path, cols, data_columns=("K_mag",) if "data_columns" in layout else (), **kw)
    got, ref = read_table(path), _csv_columns(tmp_path, cols)
    assert list(got) == list(ref)
    for c in ref:
        assert got[c].dtype == np.float64 and np.array_equal(got[c], ref[c], equal_nan=True), c


@pytest.mark.parametrize("table_format, deflate", [(False, None), (False, 4), (True, None), (True, 6)])
def test_port_written_pandas_layouts(tmp_path, table_format, deflate):
    """``chip_smoke.pandas_frame_tree`` (the card's machine has no h5py) lays
    a frame out as the h5py-built files above: the same nodes and
    attributes, and the same columns read."""
    cols = {k: np.asarray(v, dtype=np.float64) for k, v in _frame_columns().items()}
    port, ref = str(tmp_path / "port.h5"), str(tmp_path / "ref.h5")
    hdf5.write(port, pandas_frame_tree(cols, table_format=table_format, deflate=deflate))
    (pandas_hdf.write_table if table_format else pandas_hdf.write_fixed)(ref, cols, complevel=deflate)
    got, want = _h5py_items(port), _h5py_items(ref)
    assert set(got) == set(want)
    for key in ("df@pandas_type", "df@table_type", "df@values_cols", "df@non_index_axes", "df/table@values_block_0_kind",
                "df/axis0@kind", "df/axis1@kind", "df/block0_items"):
        if key in want:
            assert np.array_equal(got[key], want[key]), key
    a, b = read_table(port), read_table(ref)
    assert list(a) == list(b) and all(np.array_equal(a[c], b[c], equal_nan=True) for c in a)


def test_pandas_tables_refused(tmp_path):
    cols = _frame_columns()
    obj = dict(cols, name=np.array([f"s{i}" for i in range(len(cols["J_mag"]))], dtype=object))
    path = str(tmp_path / "object.h5")
    pandas_hdf.write_fixed(path, obj)
    with pytest.raises(ValueError, match=r"columns \['name'\] are an object block"):
        read_table(path)
    strings = str(tmp_path / "strings.h5")
    pandas_hdf.write_table(strings, dict(cols, band=np.array([b"J"] * len(cols["J_mag"]))))
    with pytest.raises(ValueError, match=r"columns \['band'\] are stored as"):
        read_table(strings)
    lzf = str(tmp_path / "lzf.h5")
    with h5py.File(lzf, "w") as f:
        f.create_dataset("x", data=np.arange(10.0), chunks=(5,), compression="lzf")
    pandas_hdf.write_fixed(str(tmp_path / "two.h5"), cols)
    with h5py.File(str(tmp_path / "two.h5"), "a") as f:
        f.copy(f["df"], "other")
    with pytest.raises(ValueError, match="2 pandas objects"):
        read_hdf_table(str(tmp_path / "two.h5"))
    # a table compressed with another filter names it
    table = str(tmp_path / "blosc.h5")
    pandas_hdf.write_table(table, cols)
    with h5py.File(table, "a") as f:
        rec = f["df/table"][()]
        attrs = dict(f["df/table"].attrs)
        del f["df/table"]
        t = f.create_dataset("df/table", data=rec, chunks=(4,), compression="lzf")
        for k, v in attrs.items():
            t.attrs[k] = v
    with pytest.raises(ValueError, match="lzf filter"):
        read_table(table)
    # not an HDF file under an HDF name: refused, never read as CSV
    fake = str(tmp_path / "fake.hdf5")
    _not_hdf5(fake)
    with pytest.raises(ValueError, match="HDF5 signature"):
        read_table(fake)
