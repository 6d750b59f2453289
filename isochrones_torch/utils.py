"""Math / small utilities (counterpart of ``isochrones_tpu/utils.py``).
Host code on numpy, but ``trapz`` and ``polyval``, which take and return
torch tensors on any device.

Also the results container of the port: the JAX package's HDF5 layout,
read and written by :mod:`isochrones_torch.hdf5` (no h5py). Under a group
``path`` (``""`` for the root) a model keeps ``samples/values`` and
``derived_samples/values`` (float64 matrices, their column names as a JSON
string in the group's ``columns`` attribute), ``obs/values`` for a tree
model, and its attributes on the group, as ``starmodel.py`` of the JAX
package writes them. :func:`load_results` also reads the ``.npz`` container
that the port wrote before it wrote HDF5 (the same content: every array
under a key shaped like its HDF5 path, every attribute a JSON string under
``<path>/attrs/<name>``); the two are told apart by their first bytes.

``download_file`` fetches a URL with ``requests``, imported only then.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from . import hdf5

# Physical constants in cgs (values of astropy.constants at reference epoch).
G_CGS = 6.6743e-08
MSUN_CGS = 1.98840987069805e33
RSUN_CGS = 6.957e10


def trapz(y, x):
    """Trapezoid rule over the last axis (reference: isochrones/utils.py:96-105)."""
    y, x = torch.as_tensor(y), torch.as_tensor(x)
    dx = x[..., 1:] - x[..., :-1]
    return torch.sum(0.5 * (y[..., 1:] + y[..., :-1]) * dx, dim=-1)


def polyval(p, x):
    """Horner polynomial evaluation, highest degree first (reference:
    isochrones/utils.py:108-114)."""
    p, x = torch.as_tensor(p), torch.as_tensor(x)
    result = torch.zeros_like(x * p[0])
    for coeff in p:
        result = result * x + coeff
    return result


def band_pairs(bands):
    """Each band paired with the last (reference: isochrones/utils.py:13-14)."""
    return [(bands[i], bands[-1]) for i in range(len(bands) - 1)]


def addmags(*mags):
    """NumPy/host magnitude addition with optional (mag, unc) pairs
    (reference: isochrones/utils.py:43-64)."""
    tot = 0
    uncs = []
    for mag in mags:
        if np.isscalar(mag) or isinstance(mag, np.ndarray) or not hasattr(mag, "__len__"):
            tot = tot + 10 ** (-0.4 * np.asarray(mag))
        else:
            try:
                m, dm = mag
            except (TypeError, ValueError):
                tot = tot + 10 ** (-0.4 * np.asarray(mag))
                continue
            f = 10 ** (-0.4 * np.asarray(m))
            tot = tot + f
            uncs.append(f * (1 - 10 ** (-0.4 * np.asarray(dm))))

    totmag = -2.5 * np.log10(tot)
    if uncs:
        f_unc = np.sqrt(np.sum([u ** 2 for u in uncs], axis=0))
        return totmag, -2.5 * np.log10(1 - f_unc / tot)
    return totmag


def fast_addmags(mags):
    """Total magnitude of a sequence of magnitudes, a float (reference:
    isochrones/utils.py:67-75)."""
    if not np.ndim(mags):
        return float(mags)
    return float(-2.5 * np.log10(np.sum(10 ** (-0.4 * np.asarray(mags, dtype=float)))))


def distance(pos0, pos1):
    """Distance between two (separation, PA) positions (reference: isochrones/utils.py:78-93)."""
    r0, pa0 = pos0
    ra0 = r0 * np.sin(pa0 * np.pi / 180)
    dec0 = r0 * np.cos(pa0 * np.pi / 180)
    r1, pa1 = pos1
    ra1 = r1 * np.sin(pa1 * np.pi / 180)
    dec1 = r1 * np.cos(pa1 * np.pi / 180)
    return np.sqrt((ra1 - ra0) ** 2 + (dec1 - dec0) ** 2)


#: the model attributes that the JAX layout keeps as they are (the others
#: are JSON strings)
_PLAIN_ATTRS = ("ic_type", "name", "directory", "use_emcee", "N")
_ZIP = b"PK\x03\x04"


def load_results(filename):
    """A results file as an :class:`~isochrones_torch.hdf5.Tree` in the JAX
    package's layout: an HDF5 file, or the port's earlier ``.npz`` container
    (told apart by their first bytes); anything else raises ``ValueError``."""
    with open(filename, "rb") as f:
        head = f.read(8)
    if head == hdf5.SIGNATURE:
        return hdf5.read(filename)
    if head[:4] == _ZIP:
        with np.load(filename, allow_pickle=False) as f:
            return _tree_from_npz({k: f[k] for k in f.files})
    raise ValueError(f"{filename} is neither an HDF5 file nor the port's .npz results container")


def _tree_from_npz(entries):
    """The tree of the port's ``.npz`` container: ``<group>/columns`` ->
    the group's ``columns``, ``<group>/attrs/<name>`` -> its attribute (the
    model's plain ones decoded from JSON), ``obs/values`` as the JAX
    package's record (fixed-length byte strings)."""
    tree = hdf5.Tree()
    for key, value in entries.items():
        head, _, name = key.rpartition("/")
        if head.endswith("attrs") and head.rpartition("/")[2] == "attrs":
            group = tree.require(head.rpartition("/")[0])
            text = str(value)
            plain = name in _PLAIN_ATTRS and not head.rpartition("/")[0].endswith("obs")
            group.attrs[name] = json.loads(text) if plain else text
        elif name == "columns":
            tree.require(head).attrs["columns"] = str(value)
        elif value.dtype.names:
            tree.require(head)[name] = value.astype([(n, f"S{value.dtype[n].itemsize // 4}")
                                                     if value.dtype[n].kind == "U" else (n, value.dtype[n])
                                                     for n in value.dtype.names])
        else:
            tree.require(head)[name] = value
    return tree


def open_results(filename, path, key, overwrite, append):
    """The results tree of ``filename`` to write into (empty without the
    file): an existing ``<path>/<key>`` raises unless ``overwrite`` (the file
    starts afresh) or ``append`` (the entry is replaced), as the JAX
    package's ``save_hdf`` does."""
    if not os.path.exists(filename):
        return hdf5.Tree()
    tree = load_results(filename)
    group = tree.get_path(path)
    if group is not None and key in group:
        if overwrite:
            return hdf5.Tree()
        if not append:
            raise IOError(f"{path} in {filename} exists. Set overwrite or append.")
    return tree


def table_group(table):
    """A dict of columns as the JAX layout's group: ``values`` (float64,
    one column a field) and ``attrs["columns"]`` (their names, JSON)."""
    cols = list(table)
    return hdf5.Tree({"values": np.stack([np.asarray(table[c], dtype=float) for c in cols], axis=1)},
                     attrs={"columns": json.dumps(cols)})


def stored_table(group, key):
    """The dict of columns stored as ``group[key]`` (see :func:`table_group`),
    or None."""
    if group is None or key not in group:
        return None
    values = np.asarray(group[key]["values"])
    return {c: values[:, i] for i, c in enumerate(json.loads(group[key].attrs["columns"]))}


def download_file(url, path=None, clobber=False):
    """Streamed HTTP download to ``path`` (reference: isochrones/utils.py:17-40).
    An existing ``path`` is kept unless ``clobber``; ``config.OFFLINE``
    refuses the download."""
    from .config import OFFLINE
    from .logger import getLogger

    if path is None:
        raise ValueError("path is required")
    if os.path.exists(path) and not clobber:
        getLogger().info("%s exists; not downloading.", path)
        return path
    if OFFLINE:
        raise RuntimeError(f"Offline mode: cannot download {url}")

    import requests

    r = requests.get(url, stream=True)
    r.raise_for_status()
    with open(path, "wb") as f:
        for chunk in r.iter_content(chunk_size=1 << 20):
            if chunk:
                f.write(chunk)
    return path
