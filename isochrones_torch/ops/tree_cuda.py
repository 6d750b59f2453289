"""Hand-written CUDA kernel for the observation-tree likelihood.

Replaces the tree likelihood that the JAX package leaves to XLA
(``isochrones_tpu/observation.py:1269-1361``); the source is
``isochrones_torch/csrc/tree_lnlike.cu``, whose header says what bounds it on
the card and what its (simple) design is. The plain version it replaces sits
beside it in :mod:`isochrones_torch.ops.tree`.

The wrapper describes the grids and the plan in one by-value argument struct
(axis kinds and constants, knot pointers, band columns, pointers to the
plan's device arrays), built once per
:class:`~isochrones_torch.ops.tree.TreeLikelihood` and patched with the
per-call pointers. Caps of this version: :data:`MAX_STARS` model stars,
:data:`MAX_OBS` observation rows, :data:`MAX_BANDS` bands; a plan beyond a cap
raises ``ValueError``.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from ._build import load_library
from .star_cuda import _Axis, _axes
from .tree import TreeLikelihood

__all__ = ["tree_lnlike_cuda", "MAX_STARS", "MAX_OBS", "MAX_BANDS"]

MAX_STARS = 16
MAX_OBS = 64
MAX_BANDS = 16

_PTR = ctypes.c_void_p
#: the plan's device arrays, in the order of ``TreeArgs``
_PLAN_FIELDS = (
    "star_param_idx", "member", "obs_band", "obs_val", "obs_unc", "obs_ref", "obs_active",
    "spec_star", "spec_prop", "spec_val", "spec_unc", "lim_star", "lim_prop", "lim_lo", "lim_hi",
    "plax_idx", "plax_val", "plax_unc", "av_idx", "av_val", "av_unc",
)
_INT_FIELDS = {"star_param_idx", "obs_band", "obs_ref", "obs_active", "spec_star", "spec_prop",
               "lim_star", "lim_prop", "plax_idx", "av_idx"}


class _TreeArgs(ctypes.Structure):
    """Mirror of ``TreeArgs`` in ``csrc/tree_lnlike.cu`` (checked by size)."""

    _fields_ = (
        [("pars", _PTR), ("ll", _PTR), ("model", _PTR), ("dens_table", _PTR), ("bc", _PTR)]
        + [(name, _PTR) for name in _PLAN_FIELDS]
        + [("B", ctypes.c_longlong), ("P", ctypes.c_int), ("n_stars", ctypes.c_int), ("n_obs", ctypes.c_int),
           ("n_bands", ctypes.c_int), ("n_spec", ctypes.c_int), ("n_lim", ctypes.c_int), ("n_plax", ctypes.c_int),
           ("n_av", ctypes.c_int), ("io", ctypes.c_int * 5), ("bc_ncols", ctypes.c_int),
           ("dens_row_len", ctypes.c_int), ("dens_col", ctypes.c_int), ("band_cols", ctypes.c_int * MAX_BANDS),
           ("model_ax", _Axis * 3), ("bc_ax", _Axis * 4)]
    )


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel library with the tree entry points' C signatures declared."""
    lib = load_library()
    for name in ("tree_lnlike_f32", "tree_lnlike_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_TreeArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in ("tree_lnlike_args_size", "tree_lnlike_max_bands", "tree_lnlike_max_stars", "tree_lnlike_max_obs"):
        getattr(lib, name).restype = ctypes.c_int
    lib.tree_lnlike_error_string.argtypes = [ctypes.c_int]
    lib.tree_lnlike_error_string.restype = ctypes.c_char_p
    if lib.tree_lnlike_args_size() != ctypes.sizeof(_TreeArgs):
        raise RuntimeError(f"TreeArgs layout differs: C {lib.tree_lnlike_args_size()} bytes, "
                           f"ctypes {ctypes.sizeof(_TreeArgs)}")
    caps = (lib.tree_lnlike_max_stars(), lib.tree_lnlike_max_obs(), lib.tree_lnlike_max_bands())
    if caps != (MAX_STARS, MAX_OBS, MAX_BANDS):
        raise RuntimeError(f"tree kernel caps {caps} differ from the wrapper's")
    return lib


def check_caps(lk: TreeLikelihood):
    """Raise ``ValueError`` naming the cap that the plan exceeds."""
    if not 1 <= lk.n_stars <= MAX_STARS:
        raise ValueError(f"tree kernel takes 1-{MAX_STARS} model stars (MAX_STARS), got {lk.n_stars}")
    if lk.n_obs > MAX_OBS:
        raise ValueError(f"tree kernel takes at most {MAX_OBS} observation rows (MAX_OBS), got {lk.n_obs}")
    if len(lk.band_icols) > MAX_BANDS:
        raise ValueError(f"tree kernel takes at most {MAX_BANDS} bands (MAX_BANDS), got {len(lk.band_icols)}")


#: per-likelihood argument struct template (pointers to its grids, knots and
#: plan arrays, which the TreeLikelihood keeps alive)
_TEMPLATES = weakref.WeakKeyDictionary()


def _template(lk: TreeLikelihood, dtype, device):
    key = (dtype, device)
    cached = _TEMPLATES.get(lk)
    if cached is not None and cached[0] == key:
        return cached[1]
    check_caps(lk)
    if len(lk.model.knots) != 3 or lk.model.values.shape[-1] != 4 or tuple(lk.model_icols) != (0, 1, 2, 3):
        raise ValueError("tree kernel needs a 3-d, 4-column packed model table (Teff, logg, feh, Mbol)")
    if len(lk.bc.knots) != 4:
        raise ValueError("tree kernel needs a 4-d BC table")
    a = _TreeArgs()
    a.model = lk.model.values.data_ptr()
    a.bc = lk.bc.values.data_ptr()
    a.model_ax[:] = _axes(lk.model, dtype, device, "model")
    a.bc_ax[:] = _axes(lk.bc, dtype, device, "BC")
    a.dens_table = None
    if lk.full_model is not None:
        _axes(lk.full_model, dtype, device, "full model")  # same axes; checks dtype, device, layout
        a.dens_table = lk.full_model.values.data_ptr()
        a.dens_row_len = lk.full_model.values.shape[-1]
        a.dens_col = int(lk.density_icol)
        if not 0 <= a.dens_col < a.dens_row_len:
            raise ValueError(f"density column {a.dens_col} outside the model table")
    for name in _PLAN_FIELDS:
        t = getattr(lk, name)
        want = torch.int32 if name in _INT_FIELDS else dtype
        if t.device != device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"plan array {name} must be a contiguous {want} tensor on {device}")
        setattr(a, name, t.data_ptr() if t.numel() else None)
    a.P = lk.n_params
    a.n_stars, a.n_obs, a.n_bands = lk.n_stars, lk.n_obs, len(lk.band_icols)
    a.n_spec, a.n_lim, a.n_plax, a.n_av = len(lk.spec_star), len(lk.lim_star), len(lk.plax_idx), len(lk.av_idx)
    a.io[:] = [int(i) for i in lk.index_order[:5]]
    a.bc_ncols = lk.bc.values.shape[-1]
    for i, c in enumerate(lk.band_icols):
        if not 0 <= c < a.bc_ncols:
            raise ValueError(f"band column {c} outside the BC table")
        a.band_cols[i] = int(c)
    # every index the kernel follows is checked here, once per plan
    for name, hi in (("star_param_idx", lk.n_params), ("obs_band", a.n_bands), ("spec_star", lk.n_stars),
                     ("spec_prop", 4), ("lim_star", lk.n_stars), ("lim_prop", 4), ("plax_idx", lk.n_params),
                     ("av_idx", lk.n_params)):
        t = getattr(lk, name)
        if t.numel() and not (0 <= int(t.min()) and int(t.max()) < hi):
            raise ValueError(f"plan array {name} holds an index outside [0, {hi})")
    if lk.obs_ref.numel() and not (-1 <= int(lk.obs_ref.min()) and int(lk.obs_ref.max()) < lk.n_obs):
        raise ValueError("plan array obs_ref holds a row outside the plan")
    _TEMPLATES[lk] = (key, a)
    return a


def tree_lnlike_cuda(p: torch.Tensor, lk: TreeLikelihood) -> torch.Tensor:
    """``ll (B,)`` from one kernel launch. Raises on anything the kernel does
    not take, and if the launch fails."""
    dt, dev = p.dtype, p.device
    if dev.type != "cuda":
        raise ValueError(f"tree_lnlike_cuda needs CUDA tensors, got {dev}")
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"tree_lnlike_cuda takes float32 or float64, got {dt}")
    if p.dim() != 2 or p.shape[1] != lk.n_params:
        raise ValueError(f"pars must be (B, {lk.n_params}), got {tuple(p.shape)}")
    lib = _lib()
    a = _template(lk, dt, dev)
    p = p.contiguous()
    B = p.shape[0]
    ll = torch.empty(B, dtype=dt, device=dev)
    call = _TreeArgs.from_buffer_copy(a)
    call.pars, call.ll, call.B = p.data_ptr(), ll.data_ptr(), B
    fn = lib.tree_lnlike_f32 if dt == torch.float32 else lib.tree_lnlike_f64
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(call), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tree_lnlike kernel launch failed: {lib.tree_lnlike_error_string(err).decode()} ({err})")
    tree_lnlike_cuda.launches += 1
    return ll


#: kernel launches made through this wrapper (reset by callers that count)
tree_lnlike_cuda.launches = 0
