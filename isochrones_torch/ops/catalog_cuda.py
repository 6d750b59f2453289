"""Hand-written CUDA kernel for the catalog likelihood.

Replaces the likelihood half of the JAX package's XLA-fused catalog
posterior (``isochrones_tpu/batch.py:145-192``); the source is
``isochrones_torch/csrc/catalog_lnlike.cu``, whose header says what bounds it
on the card and how the design answers that. The plain version it replaces
sits beside it in :mod:`isochrones_torch.ops.catalog`.

The wrapper describes both grids in one by-value argument struct (axis kinds
and constants, knot pointers, band columns), and packs the stars'
observations into one ``(S, 8 + 2 n_bands)`` block on the device, both built
once per :class:`~isochrones_torch.ops.catalog.CatalogLikelihood`; each call
patches in its pointers. Caps: 16 bands, and ``S * B * G < 2**31`` threads
(G, the lanes per point, from :func:`group_lanes`). Past a cap it raises a
``ValueError`` that names it; it never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from ._build import load_library
from .catalog import CatalogLikelihood
from .star_cuda import _Axis, _axes

__all__ = ["catalog_lnlike_cuda", "group_lanes"]

_MAX_BANDS = 16
_MAX_THREADS = 1 << 31


class _CatalogArgs(ctypes.Structure):
    """Mirror of ``CatalogArgs`` in ``csrc/catalog_lnlike.cu`` (checked by size)."""

    _fields_ = [
        ("pars", ctypes.c_void_p), ("model", ctypes.c_void_p), ("bc", ctypes.c_void_p), ("obs", ctypes.c_void_p),
        ("ll", ctypes.c_void_p), ("orig", ctypes.c_void_p), ("deriv", ctypes.c_void_p),
        ("S", ctypes.c_longlong), ("B", ctypes.c_longlong), ("io", ctypes.c_int * 3), ("n_bands", ctypes.c_int),
        ("bc_ncols", ctypes.c_int), ("row_len", ctypes.c_int), ("has_plax", ctypes.c_int),
        ("band_cols", ctypes.c_int * _MAX_BANDS), ("model_ax", _Axis * 3), ("bc_ax", _Axis * 4),
    ]


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel library with the catalog entry points' C signatures declared."""
    lib = load_library()
    for name in ("catalog_lnlike_f32", "catalog_lnlike_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_CatalogArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.catalog_lnlike_args_size.restype = ctypes.c_int
    lib.catalog_lnlike_max_bands.restype = ctypes.c_int
    lib.catalog_lnlike_group_lanes.argtypes = [ctypes.c_longlong]
    lib.catalog_lnlike_group_lanes.restype = ctypes.c_int
    lib.star_lnlike_error_string.argtypes = [ctypes.c_int]
    lib.star_lnlike_error_string.restype = ctypes.c_char_p
    if lib.catalog_lnlike_args_size() != ctypes.sizeof(_CatalogArgs):
        raise RuntimeError(f"CatalogArgs layout differs: C {lib.catalog_lnlike_args_size()} bytes, "
                           f"ctypes {ctypes.sizeof(_CatalogArgs)}")
    if lib.catalog_lnlike_max_bands() != _MAX_BANDS:
        raise RuntimeError("catalog kernel band limit differs from the wrapper's")
    return lib


def group_lanes(n_points: int) -> int:
    """Lanes per (star, point) the kernel takes for ``S * B = n_points``."""
    return int(_lib().catalog_lnlike_group_lanes(int(n_points)))


def _pack_observations(lk: CatalogLikelihood) -> torch.Tensor:
    """The stars' observations as the kernel reads them: one contiguous
    ``(S, 8 + 2 n_bands)`` block of rows ``[Teff, logg, feh, their errors,
    magnitudes, their errors, parallax, its error]`` (NaN parallax columns
    when the catalog has none), in the observations' dtype and device."""
    S = lk.n_stars
    ref = lk.spec_vals
    if lk.plax is not None:
        plax = torch.stack([lk.plax, lk.plax_unc], dim=-1)
    else:
        plax = torch.full((S, 2), float("nan"), dtype=ref.dtype, device=ref.device)
    parts = [lk.spec_vals, lk.spec_uncs, lk.mag_vals, lk.mag_uncs, plax]
    return torch.cat([x.to(ref.dtype).reshape(S, -1) for x in parts], dim=-1).contiguous()


#: per-likelihood (argument struct template, observation block)
_TEMPLATES = weakref.WeakKeyDictionary()


def _template(lk: CatalogLikelihood, dtype, device):
    key = (dtype, device)
    cached = _TEMPLATES.get(lk)
    if cached is not None and cached[0] == key:
        return cached[1], cached[2]
    nb = len(lk.band_icols)
    if nb > _MAX_BANDS:
        raise ValueError(f"catalog kernel takes at most {_MAX_BANDS} bands, got {nb}")
    if len(lk.pack6.knots) != 3 or lk.pack6.values.shape[-1] != 6:
        raise ValueError("catalog kernel needs a 3-d, 6-column packed model table")
    if len(lk.bc.knots) != 4:
        raise ValueError("catalog kernel needs a 4-d BC table")
    if sorted(int(i) for i in lk.index_order[:3]) != [0, 1, 2]:
        raise ValueError(f"catalog kernel needs (eep, age, feh) on the grid axes, got index order {lk.index_order}")
    obs = _pack_observations(lk)
    if obs.device != device or obs.dtype != dtype:
        raise ValueError(f"catalog observations must be {dtype} tensors on {device}, got {obs.dtype} on {obs.device}")
    a = _CatalogArgs()
    a.model = lk.pack6.values.data_ptr()
    a.bc = lk.bc.values.data_ptr()
    a.obs = obs.data_ptr()
    a.io[:] = [int(i) for i in lk.index_order[:3]]
    a.n_bands = nb
    a.bc_ncols = lk.bc.values.shape[-1]
    a.row_len = obs.shape[1]
    a.has_plax = int(lk.plax is not None)
    for i, c in enumerate(lk.band_icols):
        if not 0 <= c < a.bc_ncols:
            raise ValueError(f"band column {c} outside the BC table")
        a.band_cols[i] = int(c)
    a.model_ax[:] = _axes(lk.pack6, dtype, device, "model")
    a.bc_ax[:] = _axes(lk.bc, dtype, device, "BC")
    _TEMPLATES[lk] = (key, a, obs)
    return a, obs


def catalog_lnlike_cuda(pars: torch.Tensor, lk: CatalogLikelihood):
    """``(ll, orig_val, deriv)``, each ``(S, B)``, from one kernel launch.
    Raises on anything the kernel does not take, and if the launch fails."""
    dt, dev = pars.dtype, pars.device
    if dev.type != "cuda":
        raise ValueError(f"catalog_lnlike_cuda needs CUDA tensors, got {dev}")
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"catalog_lnlike_cuda takes float32 or float64, got {dt}")
    S = lk.n_stars
    if pars.dim() != 3 or pars.shape[0] != S or pars.shape[2] != 5:
        raise ValueError(f"pars must be ({S}, B, 5), got {tuple(pars.shape)}")
    lib = _lib()
    a, _ = _template(lk, dt, dev)
    B = pars.shape[1]
    if S * B * group_lanes(S * B) >= _MAX_THREADS:
        raise ValueError(f"catalog kernel takes S * B * lanes < 2**31 threads, got S={S}, B={B}")
    pars = pars.contiguous()
    ll = torch.empty((S, B), dtype=dt, device=dev)
    orig = torch.empty((S, B), dtype=dt, device=dev)
    deriv = torch.empty((S, B), dtype=dt, device=dev)
    call = _CatalogArgs.from_buffer_copy(a)
    call.pars, call.ll, call.orig, call.deriv = pars.data_ptr(), ll.data_ptr(), orig.data_ptr(), deriv.data_ptr()
    call.S, call.B = S, B
    fn = lib.catalog_lnlike_f32 if dt == torch.float32 else lib.catalog_lnlike_f64
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(call), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"catalog_lnlike kernel launch failed: {lib.star_lnlike_error_string(err).decode()} "
                           f"({err})")
    catalog_lnlike_cuda.launches += 1
    return ll, orig, deriv


#: kernel launches made through this wrapper (reset by callers that count)
catalog_lnlike_cuda.launches = 0
