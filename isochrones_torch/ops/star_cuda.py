"""Hand-written CUDA kernel for the fused star likelihood.

Replaces the likelihood half of the JAX package's XLA-fused posterior
(``isochrones_tpu/starmodel.py:430-486``); the source is
``isochrones_torch/csrc/star_lnlike.cu``, whose header says what bounds it on
the card (latency of dependent gathers) and how the design answers that. The
plain version it replaces sits beside it in :mod:`isochrones_torch.ops.star`.

The wrapper describes both grids and the observations in one by-value
argument struct (axis kinds and constants, knot pointers, band columns,
observed values), built once per :class:`~isochrones_torch.ops.star.StarLikelihood`
and patched with the per-call pointers. The kernel gives each (point,
component) a group of lanes whose width it derives from the batch (the
source's note gives the rule).

Its backward (kernel A', ``star_lnlike_grad_*`` in the same source, the
forward's team of lanes a point) replaces the JAX package's reverse-mode of
the same function, which
NUTS takes (``isochrones_tpu/samplers/nuts.py:59-69``). Where autograd
records a call, :func:`star_lnlike_cuda` goes through :class:`StarLnlike`,
whose forward is kernel A and backward kernel A'; each wrapper counts its
own launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
import weakref

import torch

from ._build import load_library
from .star import StarLikelihood

__all__ = ["star_lnlike_cuda", "star_lnlike_grad_cuda", "StarLnlike", "launch_geometry"]

_MAX_BANDS = 16
#: axis-map kind -> the kernel's AxisKind (None: searchsorted)
_KINDS = {None: 0, "exact_affine": 1, "affine": 2, "log": 3, "compare": 4}


class _Axis(ctypes.Structure):
    _fields_ = [("knots", ctypes.c_void_p), ("n", ctypes.c_longlong), ("lo0", ctypes.c_double),
                ("step", ctypes.c_double), ("kind", ctypes.c_int), ("pad", ctypes.c_int)]


class _StarArgs(ctypes.Structure):
    """Mirror of ``StarArgs`` in ``csrc/star_lnlike.cu`` (checked by size)."""

    _fields_ = [
        ("pars", ctypes.c_void_p), ("model", ctypes.c_void_p), ("bc", ctypes.c_void_p),
        ("ll", ctypes.c_void_p), ("orig", ctypes.c_void_p), ("deriv", ctypes.c_void_p),
        ("B", ctypes.c_longlong), ("N", ctypes.c_int), ("P", ctypes.c_int),
        ("io", ctypes.c_int * 5), ("n_bands", ctypes.c_int), ("bc_ncols", ctypes.c_int),
        ("dist_idx", ctypes.c_int), ("band_cols", ctypes.c_int * _MAX_BANDS),
        ("has_spec", ctypes.c_int * 3), ("spec_val", ctypes.c_double * 3), ("spec_unc", ctypes.c_double * 3),
        ("mag_val", ctypes.c_double * _MAX_BANDS), ("mag_unc", ctypes.c_double * _MAX_BANDS),
        ("plax", ctypes.c_double), ("plax_unc", ctypes.c_double),
        ("model_ax", _Axis * 3), ("bc_ax", _Axis * 4),
    ]


class _StarGradArgs(ctypes.Structure):
    """Mirror of ``StarGradArgs`` in ``csrc/star_lnlike.cu``: the cotangents
    and the gradient's output."""

    _fields_ = [("g_ll", ctypes.c_void_p), ("g_orig", ctypes.c_void_p), ("g_deriv", ctypes.c_void_p),
                ("g_pars", ctypes.c_void_p)]


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel library with the star entry points' C signatures declared."""
    lib = load_library()
    for name in ("star_lnlike_f32", "star_lnlike_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_StarArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in ("star_lnlike_grad_f32", "star_lnlike_grad_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_StarArgs), ctypes.POINTER(_StarGradArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.star_lnlike_grad_args_size.restype = ctypes.c_int
    if lib.star_lnlike_grad_args_size() != ctypes.sizeof(_StarGradArgs):
        raise RuntimeError("StarGradArgs layout differs between the kernel and the wrapper")
    lib.star_lnlike_args_size.restype = ctypes.c_int
    lib.star_lnlike_max_bands.restype = ctypes.c_int
    lib.star_lnlike_error_string.argtypes = [ctypes.c_int]
    lib.star_lnlike_error_string.restype = ctypes.c_char_p
    if lib.star_lnlike_args_size() != ctypes.sizeof(_StarArgs):
        raise RuntimeError(f"StarArgs layout differs: C {lib.star_lnlike_args_size()} bytes, "
                           f"ctypes {ctypes.sizeof(_StarArgs)}")
    if lib.star_lnlike_max_bands() != _MAX_BANDS:
        raise RuntimeError("star kernel band limit differs from the wrapper's")
    return lib


def launch_geometry(n_points: int, n_stars: int):
    """``(component groups per point, lanes per group)`` that kernels A and A'
    give a batch of ``n_points`` points with ``n_stars`` components (the rule
    is in the source's note)."""
    fn = _lib().star_lnlike_geometry  # declared here: another version's library may lack it
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    groups, lanes = ctypes.c_int(), ctypes.c_int()
    fn(int(n_points), int(n_stars), ctypes.byref(groups), ctypes.byref(lanes))
    return groups.value, lanes.value


def _axes(grid, dtype, device, name):
    """The kernel's axis descriptions of ``grid``; raises on what it does not take."""
    vals = grid.values
    if vals.device != device or vals.dtype != dtype or not vals.is_contiguous():
        raise ValueError(f"{name} table must be a contiguous {dtype} tensor on {device}")
    if vals.data_ptr() % 16:
        raise ValueError(f"{name} table must be 16-byte aligned (the kernels read packed rows two values per load)")
    if tuple(vals.shape[:-1]) != tuple(k.shape[0] for k in grid.knots):
        raise ValueError(f"{name} table shape {tuple(vals.shape)} does not match its knots")
    maps = grid.axis_maps if grid.axis_maps is not None else (None,) * len(grid.knots)
    out = []
    for k, amap in zip(grid.knots, maps):
        if k.device != device or k.dtype != dtype or not k.is_contiguous() or k.shape[0] < 1:
            raise ValueError(f"{name} knots must be non-empty contiguous {dtype} tensors on {device}")
        kind = None if amap is None else amap[0]
        if kind not in _KINDS:
            raise ValueError(f"{name}: axis map {amap!r} is not one the star kernel takes")
        lo0, step = (0.0, 0.0) if amap is None else (float(amap[1]), float(amap[2]))
        out.append(_Axis(k.data_ptr(), k.shape[0], lo0, step, _KINDS[kind], 0))
    return out


#: per-likelihood argument struct template (pointers to its grids and knots,
#: which the StarLikelihood keeps alive)
_TEMPLATES = weakref.WeakKeyDictionary()


def _template(lk: StarLikelihood, dtype, device):
    key = (dtype, device)
    cached = _TEMPLATES.get(lk)
    if cached is not None and cached[0] == key:
        return cached[1]
    if not 1 <= lk.n_stars <= 3:
        raise ValueError(f"star kernel takes 1-3 components, got {lk.n_stars}")
    nb = len(lk.band_icols)
    if nb > _MAX_BANDS:
        raise ValueError(f"star kernel takes at most {_MAX_BANDS} bands, got {nb}")
    if len(lk.pack6.knots) != 3 or lk.pack6.values.shape[-1] != 6:
        raise ValueError("star kernel needs a 3-d, 6-column packed model table")
    if len(lk.bc.knots) != 4:
        raise ValueError("star kernel needs a 4-d BC table")
    a = _StarArgs()
    a.model = lk.pack6.values.data_ptr()
    a.bc = lk.bc.values.data_ptr()
    a.N = lk.n_stars
    a.P = lk.n_stars + 4
    a.io[:] = [int(i) for i in lk.index_order[:5]]
    a.n_bands = nb
    a.bc_ncols = lk.bc.values.shape[-1]
    for i, c in enumerate(lk.band_icols):
        if not 0 <= c < a.bc_ncols:
            raise ValueError(f"band column {c} outside the BC table")
        a.band_cols[i] = int(c)
        a.mag_val[i] = float(lk.mag_vals[i])
        a.mag_unc[i] = float(lk.mag_uncs[i])
    for k in range(3):
        v, u = float(lk.spec_vals[k]), float(lk.spec_uncs[k])
        a.has_spec[k] = int(not (math.isnan(v) or math.isnan(u)))
        a.spec_val[k] = v if a.has_spec[k] else 0.0
        a.spec_unc[k] = u if a.has_spec[k] else 1.0
    a.dist_idx = -1
    if lk.parallax is not None:
        a.dist_idx = int(lk.dist_idx)
        a.plax, a.plax_unc = (float(x) for x in lk.parallax)
    a.model_ax[:] = _axes(lk.pack6, dtype, device, "model")
    a.bc_ax[:] = _axes(lk.bc, dtype, device, "BC")
    _TEMPLATES[lk] = (key, a)
    return a


def _check_pars(pars, lk, name):
    dt, dev = pars.dtype, pars.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"{name} takes float32 or float64, got {dt}")
    N = lk.n_stars
    if pars.dim() != 2 or pars.shape[1] != N + 4:
        raise ValueError(f"pars must be (B, {N + 4}), got {tuple(pars.shape)}")
    return pars.contiguous()


def _launch(fn, args, dev, what):
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: {_lib().star_lnlike_error_string(err).decode()} ({err})")


def _forward(pars: torch.Tensor, lk: StarLikelihood):
    """Kernel A's launch on checked, contiguous ``pars``."""
    dt, dev = pars.dtype, pars.device
    lib = _lib()
    a = _template(lk, dt, dev)
    N, B = lk.n_stars, pars.shape[0]
    ll = torch.empty(B, dtype=dt, device=dev)
    orig = torch.empty((B, N), dtype=dt, device=dev)
    deriv = torch.empty((B, N), dtype=dt, device=dev)
    call = _StarArgs.from_buffer_copy(a)
    call.pars, call.ll, call.orig, call.deriv = pars.data_ptr(), ll.data_ptr(), orig.data_ptr(), deriv.data_ptr()
    call.B = B
    _launch(lib.star_lnlike_f32 if dt == torch.float32 else lib.star_lnlike_f64, (ctypes.byref(call),), dev,
            "star_lnlike")
    star_lnlike_cuda.launches += 1
    return ll, orig, deriv


def star_lnlike_grad_cuda(pars: torch.Tensor, lk: StarLikelihood, g_ll, g_orig, g_deriv):
    """Kernel A': the gradient ``(B, N + 4)`` of ``sum(g_ll * ll + g_orig *
    orig_val + g_deriv * deriv)`` with respect to ``pars``, from one launch,
    by the rule of the plain version's autograd (a non-finite output passes no
    gradient). Raises on anything the kernel does not take, and if the launch
    fails."""
    pars = _check_pars(pars, lk, "star_lnlike_grad_cuda")
    dt, dev = pars.dtype, pars.device
    N, B = lk.n_stars, pars.shape[0]
    cot = []
    for name, g, shape in (("g_ll", g_ll, (B,)), ("g_orig", g_orig, (B, N)), ("g_deriv", g_deriv, (B, N))):
        if tuple(g.shape) != shape or g.dtype != dt or g.device != dev:
            raise ValueError(f"{name} must be {shape} {dt} on {dev}, got {tuple(g.shape)} {g.dtype} on {g.device}")
        cot.append(g.contiguous())
    lib = _lib()
    call = _StarArgs.from_buffer_copy(_template(lk, dt, dev))
    call.pars, call.B = pars.data_ptr(), B
    out = torch.empty((B, N + 4), dtype=dt, device=dev)
    grad = _StarGradArgs(cot[0].data_ptr(), cot[1].data_ptr(), cot[2].data_ptr(), out.data_ptr())
    _launch(lib.star_lnlike_grad_f32 if dt == torch.float32 else lib.star_lnlike_grad_f64,
            (ctypes.byref(call), ctypes.byref(grad)), dev, "star_lnlike_grad")
    star_lnlike_grad_cuda.launches += 1
    return out


class StarLnlike(torch.autograd.Function):
    """Kernel A forward, kernel A' backward."""

    @staticmethod
    def forward(ctx, pars, lk):
        ctx.save_for_backward(pars)
        ctx.lk = lk
        return _forward(pars, lk)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_ll, g_orig, g_deriv):
        (pars,) = ctx.saved_tensors
        return star_lnlike_grad_cuda(pars, ctx.lk, g_ll, g_orig, g_deriv), None


def star_lnlike_cuda(pars: torch.Tensor, lk: StarLikelihood):
    """``(ll (B,), orig_val (B, N), deriv (B, N))`` from one kernel launch;
    where autograd records the call, through :class:`StarLnlike`, whose
    backward is kernel A'. Raises on anything the kernel does not take, and if
    the launch fails."""
    pars = _check_pars(pars, lk, "star_lnlike_cuda")
    if torch.is_grad_enabled() and pars.requires_grad:
        return StarLnlike.apply(pars, lk)
    return _forward(pars, lk)


#: kernel launches made through each wrapper (reset by callers that count)
star_lnlike_cuda.launches = 0
star_lnlike_grad_cuda.launches = 0
