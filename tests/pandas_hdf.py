"""DataFrames written with h5py in the layout that ``DataFrame.to_hdf`` gives
through PyTables (``pandas/io/pytables.py``: ``FrameFixed`` for
``format="fixed"``, ``AppendableFrameTable`` for ``format="table"``), for
tests of the port's HDF table reader where PyTables is not installed.

PyTables' attribute types are kept: a ``str`` is a fixed-length string
(UTF-8, null-terminated; an empty one a null dataspace), an ``int`` an int64
scalar, a ``bool`` an 8-bit bitfield, a list, tuple, dict or None a
protocol-0 pickle in a fixed-length string, and the node attributes
(``CLASS``, ``VERSION``, ``TITLE``) null-terminated ASCII strings.
``complevel`` stores every array chunked with the shuffle and deflate
filters, as ``complib="zlib"`` does.
"""

import pickle

import h5py
import numpy as np

PANDAS_VERSION = "0.15.2"  # what pandas writes as pandas_version


def _fixed_string(value, cset):
    tid = h5py.h5t.C_S1.copy()
    tid.set_size(max(len(value), 1))
    tid.set_strpad(h5py.h5t.STR_NULLTERM)
    tid.set_cset(cset)
    return tid


def set_attr(obj, name, value, system=False):
    """One attribute as PyTables stores it."""
    bname = name.encode()
    if h5py.h5a.exists(obj.id, bname):
        h5py.h5a.delete(obj.id, bname)
    if isinstance(value, str) and not system:
        data = value.encode("utf-8")
        if not data:
            tid = _fixed_string(b"", h5py.h5t.CSET_UTF8)
            h5py.h5a.create(obj.id, bname, tid, h5py.h5s.create(h5py.h5s.NULL))
            return
        tid = _fixed_string(data, h5py.h5t.CSET_UTF8)
    elif isinstance(value, str):
        data = value.encode("ascii") + b"\0"
        tid = _fixed_string(data, h5py.h5t.CSET_ASCII)
    elif isinstance(value, bytes):
        data = bytes(value)
        tid = _fixed_string(data, h5py.h5t.CSET_ASCII)
    elif isinstance(value, (bool, np.bool_)):
        tid, data = h5py.h5t.STD_B8LE.copy(), np.array(int(value), dtype=np.uint8)
        aid = h5py.h5a.create(obj.id, bname, tid, h5py.h5s.create(h5py.h5s.SCALAR))
        aid.write(data, mtype=tid)
        return
    elif isinstance(value, (int, np.integer)):
        obj.attrs[name] = np.int64(value)
        return
    elif isinstance(value, (float, np.floating, np.ndarray)):
        obj.attrs[name] = value
        return
    else:  # PyTables pickles what HDF5 cannot hold
        data = pickle.dumps(value, 0)
        tid = _fixed_string(data, h5py.h5t.CSET_ASCII)
    aid = h5py.h5a.create(obj.id, bname, tid, h5py.h5s.create(h5py.h5s.SCALAR))
    aid.write(np.frombuffer(data.ljust(tid.get_size(), b"\0"), dtype=f"S{tid.get_size()}").reshape(()), mtype=tid)


def _node_attrs(obj, cls, version):
    set_attr(obj, "CLASS", cls, system=True)
    set_attr(obj, "VERSION", version, system=True)
    set_attr(obj, "TITLE", "")


def _array(group, name, values, complevel):
    """A PyTables ``Array`` (``CArray`` with ``complevel``) of ``values``."""
    if complevel:
        ds = group.create_dataset(name, data=values, chunks=values.shape, compression="gzip",
                                  compression_opts=complevel, shuffle=True)
        _node_attrs(ds, "CARRAY", "1.1")
    else:
        ds = group.create_dataset(name, data=values)
        _node_attrs(ds, "ARRAY", "2.4")
    set_attr(ds, "FLAVOR", "numpy", system=True)
    return ds


def _index(group, name, labels, complevel):
    """``GenericFixed.write_index`` of a flat index."""
    labels = np.asarray(labels)
    if labels.dtype.kind in "US" or labels.dtype == object:
        values = np.array([str(x).encode("utf-8") for x in labels])
        kind = "string"
    else:
        values, kind = labels.astype(np.int64), "integer"
    set_attr(group, f"{name}_variety", "regular")
    ds = _array(group, name, values, complevel)
    set_attr(ds, "transposed", False)
    set_attr(ds, "kind", kind)
    set_attr(ds, "name", None)


def _file(path, key):
    f = h5py.File(path, "w")
    _node_attrs(f, "GROUP", "1.0")
    set_attr(f, "PYTABLES_FORMAT_VERSION", "2.1", system=True)
    g = f.create_group(key)
    _node_attrs(g, "GROUP", "1.0")
    return f, g


def write_fixed(path, columns, index=None, key="df", complevel=None, blocks=None):
    """``DataFrame(columns, index).to_hdf(path, key=key, format="fixed")``.
    ``blocks`` lists the column names of each block (numeric columns of one
    dtype share a block in pandas); by default one block per dtype in
    column order. A block of ``object`` columns is written as PyTables
    writes one: a variable-length array of pickles."""
    names = list(columns)
    n = len(columns[names[0]])
    if blocks is None:
        by = {}
        for c in names:
            by.setdefault(np.asarray(columns[c]).dtype.str, []).append(c)
        blocks = list(by.values())
    f, g = _file(path, key)
    with f:
        set_attr(g, "pandas_type", "frame")
        set_attr(g, "pandas_version", PANDAS_VERSION)
        set_attr(g, "encoding", "UTF-8")
        set_attr(g, "errors", "strict")
        set_attr(g, "ndim", 2)
        _index(g, "axis0", names, complevel)
        _index(g, "axis1", np.arange(n) if index is None else index, complevel)
        set_attr(g, "nblocks", len(blocks))
        for i, items in enumerate(blocks):
            values = np.stack([np.asarray(columns[c]) for c in items], axis=0)  # the block's (items, rows)
            if values.dtype == object:
                ds = g.create_dataset(f"block{i}_values", shape=(1,), dtype=h5py.vlen_dtype(np.uint8))
                ds[0] = np.frombuffer(pickle.dumps(values.T), dtype=np.uint8)
                _node_attrs(ds, "VLARRAY", "1.4")
                set_attr(ds, "PSEUDOATOM", "object", system=True)
                set_attr(ds, "transposed", True)
            else:
                ds = _array(g, f"block{i}_values", values.T, complevel)
                set_attr(ds, "transposed", True)
            _index(g, f"block{i}_items", items, complevel)


def write_table(path, columns, index=None, key="df", complevel=None, data_columns=()):
    """``DataFrame(columns, index).to_hdf(path, key=key, format="table")``:
    the numeric columns of one dtype in one ``values_block_<i>`` field of
    the ``table`` dataset, each of ``data_columns`` in a field of its own."""
    names = list(columns)
    n = len(columns[names[0]])
    labels = np.arange(n) if index is None else np.asarray(index)
    fields, kinds = [], {}
    blocks = {}
    for c in names:
        if c in data_columns:
            kinds[c] = [c]
            fields.append((c, np.asarray(columns[c]).dtype))
        else:
            blocks.setdefault(np.asarray(columns[c]).dtype.str, []).append(c)
    values_cols = [c for c in names if c in data_columns]
    for i, (dt, items) in enumerate(blocks.items()):
        kinds[f"values_block_{i}"] = items
        fields.append((f"values_block_{i}", np.dtype(dt), (len(items),)))
        values_cols.append(f"values_block_{i}")
    if labels.dtype.kind in "US" or labels.dtype == object:
        index_values = np.array([str(x).encode("utf-8") for x in labels])
        index_kind = "string"
    else:
        index_values, index_kind = labels.astype(np.int64), "integer"
    rec = np.zeros(n, dtype=[("index", index_values.dtype)] + fields)
    rec["index"] = index_values
    for name, items in kinds.items():
        rec[name] = np.stack([np.asarray(columns[c]) for c in items], axis=-1).reshape(rec[name].shape)
    f, g = _file(path, key)
    with f:
        set_attr(g, "pandas_type", "frame_table")
        set_attr(g, "pandas_version", PANDAS_VERSION)
        set_attr(g, "table_type", "appendable_frame")
        set_attr(g, "index_cols", [(0, "index")])
        set_attr(g, "values_cols", values_cols)
        set_attr(g, "non_index_axes", [(1, names)])
        set_attr(g, "data_columns", list(data_columns))
        set_attr(g, "nan_rep", "nan")
        set_attr(g, "encoding", "UTF-8")
        set_attr(g, "errors", "strict")
        set_attr(g, "levels", 1)
        set_attr(g, "info", {1: {"names": [None], "type": "Index"}, "index": {}})
        kw = dict(compression="gzip", compression_opts=complevel, shuffle=True) if complevel else {}
        t = g.create_dataset("table", data=rec, chunks=(max(1, min(n, 2048)),), maxshape=(None,), **kw)
        _node_attrs(t, "TABLE", "2.7")
        for j, name in enumerate(rec.dtype.names):
            set_attr(t, f"FIELD_{j}_NAME", name, system=True)
            set_attr(t, f"FIELD_{j}_FILL", np.zeros((), dtype=rec.dtype[name].base)[()])
        set_attr(t, "NROWS", n)
        set_attr(t, "index_kind", index_kind)
        for name, items in kinds.items():
            set_attr(t, f"{name}_kind", items)
            set_attr(t, f"{name}_meta", None)
            set_attr(t, f"{name}_dtype", str(np.asarray(columns[items[0]]).dtype))
