"""Math / small utilities (counterpart of ``isochrones_tpu/utils.py``).
Host code on numpy, but ``trapz`` and ``polyval``, which take and return
torch tensors on any device.

Also the results container of the port. The JAX package's ``save_hdf`` /
``load_hdf`` write HDF5 through ``h5py``; the port writes the same content
into one numpy ``.npz`` file (``allow_pickle=False``): every array under a
key shaped like the HDF5 path (``<path>/samples/values``) and every
attribute as a JSON string under ``<path>/attrs/<name>``. ``path`` is a key
prefix, so several models can share a file.

``download_file`` fetches a URL with ``requests``, imported only then.
"""

from __future__ import annotations

import os

import numpy as np
import torch

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


def store_prefix(path):
    """The key prefix of ``path`` in a results container (``""`` for the root)."""
    path = (path or "").strip("/")
    return f"{path}/" if path else ""


def npz_load(filename):
    """Every entry of a results container as a dict of numpy arrays."""
    with np.load(filename, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def npz_save(filename, entries):
    """Write a results container whole and atomically (temporary file, then
    rename), under exactly the name given."""
    tmp = f"{filename}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **entries)
    os.replace(tmp, filename)


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
