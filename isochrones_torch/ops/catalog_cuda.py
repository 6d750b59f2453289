"""Hand-written CUDA kernel for the catalog posterior and likelihood.

Replaces the JAX package's XLA-fused catalog posterior
(``isochrones_tpu/batch.py:145-208``); the source is
``isochrones_torch/csrc/catalog_lnlike.cu``, whose header says what bounds it
on the card and how the design answers that. The plain versions it replaces
sit beside it in :mod:`isochrones_torch.ops.catalog`.

Two wrappers over the one kernel body: :func:`catalog_lnpost_cuda` (the
posterior, the fitter's path, one launch a call) and
:func:`catalog_lnlike_cuda` (the likelihood's ``(ll, orig_val, deriv)``).
Each counts its own launches. The wrapper describes both grids in one
by-value argument struct (axis kinds and constants, knot pointers), copies
the BC table's wanted band columns into a compact table (:func:`compact_bc`)
and packs the stars' observations into one ``(S, 8 + 2 n_bands)`` block on
the device, all built once per
:class:`~isochrones_torch.ops.catalog.CatalogLikelihood`; the posterior adds
the packed prior constants of a
:class:`~isochrones_torch.ops.catalog.CatalogPriors` once per pair; each call
patches in its pointers. Caps: 16 bands, and ``S * B < 2**31`` points (one
thread each). Past a cap it raises a ``ValueError`` that names it; it never
falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from ._build import load_library
from ._grad import refuse_grad
from .catalog import CONST_NAMES, CatalogLikelihood, CatalogPriors
from .star_cuda import _Axis, _axes

__all__ = ["catalog_lnlike_cuda", "catalog_lnpost_cuda", "compact_bc", "compact_table"]

_MAX_BANDS = 16
_MAX_POINTS = 1 << 31
#: the compact BC table's widths the kernel is instantiated for
_COMPACT_WIDTHS = (4, 8, 16)


class _CatalogArgs(ctypes.Structure):
    """Mirror of ``CatalogArgs`` in ``csrc/catalog_lnlike.cu`` (checked by size)."""

    _fields_ = [
        ("pars", ctypes.c_void_p), ("model", ctypes.c_void_p), ("bc", ctypes.c_void_p), ("obs", ctypes.c_void_p),
        ("his", ctypes.c_void_p), ("dist", ctypes.c_void_p), ("out", ctypes.c_void_p), ("orig", ctypes.c_void_p),
        ("deriv", ctypes.c_void_p), ("S", ctypes.c_longlong), ("B", ctypes.c_longlong), ("io", ctypes.c_int * 3),
        ("n_bands", ctypes.c_int), ("bc_ncols", ctypes.c_int), ("row_len", ctypes.c_int), ("has_plax", ctypes.c_int),
        ("on", ctypes.c_int * 4), ("model_ax", _Axis * 3), ("bc_ax", _Axis * 4),
        ("c", ctypes.c_double * len(CONST_NAMES)),
    ]


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel library with the catalog entry points' C signatures declared."""
    lib = load_library()
    for name in ("catalog_lnlike_f32", "catalog_lnlike_f64", "catalog_lnpost_f32", "catalog_lnpost_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_CatalogArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in ("catalog_lnlike_args_size", "catalog_lnlike_max_bands", "catalog_lnlike_n_consts"):
        getattr(lib, name).restype = ctypes.c_int
    lib.star_lnlike_error_string.argtypes = [ctypes.c_int]
    lib.star_lnlike_error_string.restype = ctypes.c_char_p
    if lib.catalog_lnlike_args_size() != ctypes.sizeof(_CatalogArgs):
        raise RuntimeError(f"CatalogArgs layout differs: C {lib.catalog_lnlike_args_size()} bytes, "
                           f"ctypes {ctypes.sizeof(_CatalogArgs)}")
    if lib.catalog_lnlike_max_bands() != _MAX_BANDS or lib.catalog_lnlike_n_consts() != len(CONST_NAMES):
        raise RuntimeError("catalog kernel band limit or prior constants differ from the wrapper's")
    return lib


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


def compact_table(bc, band_icols, widths=_COMPACT_WIDTHS) -> torch.Tensor:
    """The BC table's columns ``band_icols``, in that order, padded with
    zeros to the narrowest of ``widths`` (4, 8 or 16 columns; the forward
    model's kernel also takes 12) that holds them: a contiguous ``(b0, b1,
    b2, b3, W)`` copy. Raises past 16 bands."""
    nb = len(band_icols)
    if nb > _MAX_BANDS:
        raise ValueError(f"the kernels take at most {_MAX_BANDS} bands, got {nb}")
    bc_ncols = bc.values.shape[-1]
    for c in band_icols:
        if not 0 <= c < bc_ncols:
            raise ValueError(f"band column {c} outside the BC table")
    width = next(w for w in widths if nb <= w)
    vals = bc.values[..., [int(c) for c in band_icols]]
    pad = vals.new_zeros(vals.shape[:-1] + (width - nb,))
    return torch.cat([vals, pad], dim=-1).contiguous()


def compact_bc(lk: CatalogLikelihood) -> torch.Tensor:
    """The likelihood's band columns as :func:`compact_table` copies them."""
    return compact_table(lk.bc, lk.band_icols)


#: per-likelihood (key, argument struct template, tensors it points into)
_TEMPLATES = weakref.WeakKeyDictionary()
#: per-prior pack (the likelihood template it copies, posterior struct template, likelihood)
_POST_TEMPLATES = weakref.WeakKeyDictionary()


def _template(lk: CatalogLikelihood, dtype, device):
    """The likelihood's argument struct, with the tensors it points into."""
    key = (dtype, device)
    cached = _TEMPLATES.get(lk)
    if cached is not None and cached[0] == key:
        return cached[1]
    if len(lk.pack6.knots) != 3 or lk.pack6.values.shape[-1] != 6:
        raise ValueError("catalog kernel needs a 3-d, 6-column packed model table")
    if len(lk.bc.knots) != 4:
        raise ValueError("catalog kernel needs a 4-d BC table")
    if sorted(int(i) for i in lk.index_order[:3]) != [0, 1, 2]:
        raise ValueError(f"catalog kernel needs (eep, age, feh) on the grid axes, got index order {lk.index_order}")
    table = compact_bc(lk)
    obs = _pack_observations(lk)
    if obs.device != device or obs.dtype != dtype:
        raise ValueError(f"catalog observations must be {dtype} tensors on {device}, got {obs.dtype} on {obs.device}")
    a = _CatalogArgs()
    a.model = lk.pack6.values.data_ptr()
    a.bc, a.bc_ncols = table.data_ptr(), table.shape[-1]
    a.obs = obs.data_ptr()
    a.io[:] = [int(i) for i in lk.index_order[:3]]
    a.n_bands = len(lk.band_icols)
    a.row_len = obs.shape[1]
    a.has_plax = int(lk.plax is not None)
    a.model_ax[:] = _axes(lk.pack6, dtype, device, "model")
    a.bc_ax[:] = _axes(lk.bc, dtype, device, "BC")
    _TEMPLATES[lk] = (key, a, [obs, table])
    return a


def _post_template(lk: CatalogLikelihood, pri: CatalogPriors, dtype, device):
    base = _template(lk, dtype, device)
    cached = _POST_TEMPLATES.get(pri)
    if cached is not None and cached[0] is base and cached[2]() is lk:
        return cached[1]
    if pri.dist.shape != (lk.n_stars, 2) or pri.dist.dtype != dtype or pri.dist.device != device:
        raise ValueError(f"the priors' distance rows must be ({lk.n_stars}, 2) {dtype} on {device}, got "
                         f"{tuple(pri.dist.shape)} {pri.dist.dtype} on {pri.dist.device}")
    a = _CatalogArgs.from_buffer_copy(base)
    a.dist = pri.dist.data_ptr()
    a.on[:] = [int(x) for x in pri.on]
    a.c[:] = [float(pri.consts[n]) for n in CONST_NAMES]
    _POST_TEMPLATES[pri] = (base, a, weakref.ref(lk))
    return a


def _check_points(x, lk, name):
    dt, dev = x.dtype, x.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"{name} takes float32 or float64, got {dt}")
    S = lk.n_stars
    if x.dim() != 3 or x.shape[0] != S or x.shape[2] != 5:
        raise ValueError(f"points must be ({S}, B, 5), got {tuple(x.shape)}")
    B = x.shape[1]
    if S * B >= _MAX_POINTS:
        raise ValueError(f"catalog kernel takes S * B < 2**31 points, got S={S}, B={B}")
    return x.contiguous(), S, B


def _launch(fn, call, dev, name):
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(call), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: {_lib().star_lnlike_error_string(err).decode()} ({err})")


def catalog_lnlike_cuda(pars: torch.Tensor, lk: CatalogLikelihood):
    """``(ll, orig_val, deriv)``, each ``(S, B)``, from one kernel launch.
    Raises on anything the kernel does not take, and if the launch fails."""
    refuse_grad("catalog_lnlike_cuda", pars)
    pars, S, B = _check_points(pars, lk, "catalog_lnlike_cuda")
    dt, dev = pars.dtype, pars.device
    lib = _lib()
    call = _CatalogArgs.from_buffer_copy(_template(lk, dt, dev))
    ll, orig, deriv = (torch.empty((S, B), dtype=dt, device=dev) for _ in range(3))
    call.pars, call.out, call.orig, call.deriv = pars.data_ptr(), ll.data_ptr(), orig.data_ptr(), deriv.data_ptr()
    call.S, call.B = S, B
    _launch(lib.catalog_lnlike_f32 if dt == torch.float32 else lib.catalog_lnlike_f64, call, dev, "catalog_lnlike")
    catalog_lnlike_cuda.launches += 1
    return ll, orig, deriv


def catalog_lnpost_cuda(x: torch.Tensor, lk: CatalogLikelihood, pri: CatalogPriors, his: torch.Tensor = None):
    """``(lnpost (S, B), orig_val (S, B) or None)`` from one kernel launch:
    parameters ``x`` (S, B, 5), or unit-cube points with the box tops ``his``
    (S, 5); ``orig_val`` only when the mass prior's flag is off (the caller
    adds that term). Raises on anything the kernel does not take, and if the
    launch fails."""
    refuse_grad("catalog_lnpost_cuda", x, his)
    x, S, B = _check_points(x, lk, "catalog_lnpost_cuda")
    dt, dev = x.dtype, x.device
    lib = _lib()
    call = _CatalogArgs.from_buffer_copy(_post_template(lk, pri, dt, dev))
    if his is not None:
        if his.shape != (S, 5) or his.dtype != dt or his.device != dev:
            raise ValueError(f"his must be ({S}, 5) {dt} on {dev}, got {tuple(his.shape)} {his.dtype} on {his.device}")
        his = his.contiguous()
        call.his = his.data_ptr()
    out = torch.empty((S, B), dtype=dt, device=dev)
    orig = None if pri.on[3] else torch.empty((S, B), dtype=dt, device=dev)
    call.pars, call.out = x.data_ptr(), out.data_ptr()
    call.orig = None if orig is None else orig.data_ptr()
    call.S, call.B = S, B
    _launch(lib.catalog_lnpost_f32 if dt == torch.float32 else lib.catalog_lnpost_f64, call, dev, "catalog_lnpost")
    catalog_lnpost_cuda.launches += 1
    return out, orig


#: kernel launches made through each wrapper (reset by callers that count)
catalog_lnlike_cuda.launches = 0
catalog_lnpost_cuda.launches = 0
