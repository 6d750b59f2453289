"""Hand-written CUDA kernel for the observation-tree likelihood.

Replaces the tree likelihood that the JAX package leaves to XLA
(``isochrones_tpu/observation.py:1269-1361``) and the interpolation its tree
prior repeats per star; the source is ``isochrones_torch/csrc/tree_lnlike.cu``,
whose header says what bounds it on the card (latency of dependent gathers)
and how the design answers that: a team of lanes per point, a group of them
per star, the team's shape derived from the batch. The plain version it
replaces sits beside it in :mod:`isochrones_torch.ops.tree`.

The wrapper describes the grids in one by-value argument struct (axis kinds
and constants, knot pointers, band columns, each star's parameter columns) and
packs the plan into one small device block (:func:`pack_plan`: observed
values, one descriptor word per row), both built once per
:class:`~isochrones_torch.ops.tree.TreeLikelihood` and patched with the
per-call pointers. Caps: :data:`MAX_STARS` model stars, :data:`MAX_OBS`
observation rows, :data:`MAX_BANDS` bands, :data:`MAX_PROPS` spectroscopy rows
and as many limits; a plan beyond a cap raises ``ValueError``.

Its backward (kernel C', ``tree_lnlike_grad_*`` in the same source, one lane
a point) replaces the JAX package's reverse-mode of the tree posterior's
likelihood. Where autograd records a call, :func:`tree_lnlike_cuda` goes
through :class:`TreeLnlike`, whose forward is kernel C and backward kernel
C'; each wrapper counts its own launches.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import numpy as np
import torch

from ._build import load_library
from .star_cuda import _Axis, _axes
from .tree import TreeLikelihood

__all__ = ["tree_lnlike_cuda", "tree_lnlike_grad_cuda", "TreeLnlike", "pack_plan", "launch_geometry", "MAX_STARS",
           "MAX_OBS", "MAX_BANDS", "MAX_PROPS"]

MAX_STARS = 16
MAX_OBS = 64
MAX_BANDS = 16
MAX_PROPS = 4 * MAX_STARS

_PTR = ctypes.c_void_p


class _TreeArgs(ctypes.Structure):
    """Mirror of ``TreeArgs`` in ``csrc/tree_lnlike.cu`` (checked by size)."""

    _fields_ = (
        [(name, _PTR) for name in ("pars", "ll", "orig", "deriv", "model", "dens_table", "bc", "plan")]
        + [("B", ctypes.c_longlong), ("P", ctypes.c_int), ("n_stars", ctypes.c_int), ("n_obs", ctypes.c_int),
           ("n_bands", ctypes.c_int), ("n_spec", ctypes.c_int), ("n_lim", ctypes.c_int), ("n_plax", ctypes.c_int),
           ("n_av", ctypes.c_int), ("plan_bytes", ctypes.c_int), ("io", ctypes.c_int * 5),
           ("bc_ncols", ctypes.c_int), ("dens_row_len", ctypes.c_int), ("dens_col", ctypes.c_int),
           ("band_cols", ctypes.c_int * MAX_BANDS), ("star_par", (ctypes.c_short * 5) * MAX_STARS),
           ("model_ax", _Axis * 3), ("bc_ax", _Axis * 4)]
    )


class _TreeGradArgs(ctypes.Structure):
    """Mirror of ``TreeGradArgs`` in ``csrc/tree_lnlike.cu``: the cotangents
    and the gradient's output."""

    _fields_ = [(name, _PTR) for name in ("g_ll", "g_orig", "g_deriv", "g_pars")]


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel library with the tree entry points' C signatures declared."""
    lib = load_library()
    for name in ("tree_lnlike_f32", "tree_lnlike_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_TreeArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in ("tree_lnlike_grad_f32", "tree_lnlike_grad_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_TreeArgs), ctypes.POINTER(_TreeGradArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.tree_lnlike_grad_args_size.restype = ctypes.c_int
    if lib.tree_lnlike_grad_args_size() != ctypes.sizeof(_TreeGradArgs):
        raise RuntimeError("TreeGradArgs layout differs between the kernel and the wrapper")
    for name in ("tree_lnlike_args_size", "tree_lnlike_max_bands", "tree_lnlike_max_stars", "tree_lnlike_max_obs",
                 "tree_lnlike_max_props"):
        getattr(lib, name).restype = ctypes.c_int
    lib.tree_lnlike_geometry.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                         ctypes.POINTER(ctypes.c_int)]
    lib.tree_lnlike_geometry.restype = None
    lib.tree_lnlike_error_string.argtypes = [ctypes.c_int]
    lib.tree_lnlike_error_string.restype = ctypes.c_char_p
    if lib.tree_lnlike_args_size() != ctypes.sizeof(_TreeArgs):
        raise RuntimeError(f"TreeArgs layout differs: C {lib.tree_lnlike_args_size()} bytes, "
                           f"ctypes {ctypes.sizeof(_TreeArgs)}")
    caps = (lib.tree_lnlike_max_stars(), lib.tree_lnlike_max_obs(), lib.tree_lnlike_max_bands(),
            lib.tree_lnlike_max_props())
    if caps != (MAX_STARS, MAX_OBS, MAX_BANDS, MAX_PROPS):
        raise RuntimeError(f"tree kernel caps {caps} differ from the wrapper's")
    return lib


def launch_geometry(n_points: int, n_stars: int):
    """``(star groups per point, lanes per group)`` that the kernel gives a
    batch of ``n_points`` points of a plan with ``n_stars`` stars (the rule is
    in the source's header); with fewer groups than stars a group takes its
    stars in turn."""
    groups, lanes = ctypes.c_int(), ctypes.c_int()
    _lib().tree_lnlike_geometry(int(n_points), int(n_stars), ctypes.byref(groups), ctypes.byref(lanes))
    return groups.value, lanes.value


def check_caps(lk: TreeLikelihood):
    """Raise ``ValueError`` naming the cap that the plan exceeds."""
    if not 1 <= lk.n_stars <= MAX_STARS:
        raise ValueError(f"tree kernel takes 1-{MAX_STARS} model stars (MAX_STARS), got {lk.n_stars}")
    if lk.n_obs > MAX_OBS:
        raise ValueError(f"tree kernel takes at most {MAX_OBS} observation rows (MAX_OBS), got {lk.n_obs}")
    if len(lk.band_icols) > MAX_BANDS:
        raise ValueError(f"tree kernel takes at most {MAX_BANDS} bands (MAX_BANDS), got {len(lk.band_icols)}")
    for what, n in (("spectroscopy rows", len(lk.spec_star)), ("limits", len(lk.lim_star))):
        if n > MAX_PROPS:
            raise ValueError(f"tree kernel takes at most {MAX_PROPS} {what} (MAX_PROPS), got {n}")
    for what, n in (("parallax", len(lk.plax_idx)), ("AV", len(lk.av_idx))):
        if n > MAX_STARS:
            raise ValueError(f"tree kernel takes at most {MAX_STARS} {what} rows (MAX_STARS), got {n}")


def pack_plan(lk: TreeLikelihood, dtype) -> np.ndarray:
    """The plan as the one block of bytes the kernel copies to shared memory
    (layout in ``TreeArgs``): the value arrays in ``dtype``, then a 32-bit
    word per row, padded to a multiple of 16 bytes. Every index the kernel
    follows is checked here, once per plan."""
    check_caps(lk)

    def host(name):
        return getattr(lk, name).detach().cpu().numpy()

    n_stars, n_obs, n_bands = lk.n_stars, lk.n_obs, len(lk.band_icols)
    for name, hi in (("obs_band", n_bands), ("spec_star", n_stars), ("spec_prop", 4), ("lim_star", n_stars),
                     ("lim_prop", 4), ("plax_idx", lk.n_params), ("av_idx", lk.n_params)):
        t = host(name)
        if t.size and not (0 <= t.min() and t.max() < hi):
            raise ValueError(f"plan array {name} holds an index outside [0, {hi})")
    member, ref = host("member"), host("obs_ref").astype(np.int64)
    if member.shape != (n_obs, n_stars) or not np.isin(member, (0.0, 1.0)).all():
        raise ValueError("plan array member must be an (n_obs, n_stars) matrix of 0 and 1")
    if ref.size and not (-1 <= ref.min() and ref.max() < n_obs):
        raise ValueError("plan array obs_ref holds a row outside the plan")
    mask = (member.astype(np.int64) << np.arange(n_stars)).sum(axis=1) if n_obs else np.zeros(0, np.int64)
    obs_desc = (host("obs_band").astype(np.int64) | ((ref + 1) << 4) | ((host("obs_active") > 0).astype(np.int64) << 11)
                | (mask << 16))
    words = [obs_desc] + [host(f"{k}_star").astype(np.int64) | (host(f"{k}_prop").astype(np.int64) << 8)
                          for k in ("spec", "lim")] + [host("plax_idx"), host("av_idx")]
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    values = [host(name).astype(np_dtype) for name in ("obs_val", "obs_unc", "spec_val", "spec_unc", "lim_lo", "lim_hi",
                                                       "plax_val", "plax_unc", "av_val", "av_unc")]
    raw = b"".join(v.tobytes() for v in values) + b"".join(w.astype(np.uint32).tobytes() for w in words)
    return np.frombuffer(raw + bytes(-len(raw) % 16), dtype=np.uint8)


#: per-likelihood argument struct template and packed plan (the template
#: points to the plan block and to the likelihood's grids and knots, which
#: the TreeLikelihood keeps alive)
_TEMPLATES = weakref.WeakKeyDictionary()


def _template(lk: TreeLikelihood, dtype, device):
    key = (dtype, device)
    cached = _TEMPLATES.get(lk)
    if cached is not None and cached[0] == key:
        return cached[1]
    if len(lk.model.knots) != 3 or lk.model.values.shape[-1] != 6:
        raise ValueError("tree kernel needs a 3-d, 6-column packed model table")
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
    for name in ("obs_val", "obs_unc", "spec_val", "spec_unc", "lim_lo", "lim_hi", "plax_val", "plax_unc", "av_val",
                 "av_unc", "member"):
        if getattr(lk, name).dtype != dtype:
            raise ValueError(f"plan array {name} must be of the grids' dtype {dtype}")
    plan = torch.from_numpy(pack_plan(lk, dtype).copy()).to(device)
    a.plan, a.plan_bytes = plan.data_ptr(), plan.numel()
    a.P = lk.n_params
    a.n_stars, a.n_obs, a.n_bands = lk.n_stars, lk.n_obs, len(lk.band_icols)
    a.n_spec, a.n_lim, a.n_plax, a.n_av = len(lk.spec_star), len(lk.lim_star), len(lk.plax_idx), len(lk.av_idx)
    a.io[:] = [int(i) for i in lk.index_order[:5]]
    a.bc_ncols = lk.bc.values.shape[-1]
    for i, c in enumerate(lk.band_icols):
        if not 0 <= c < a.bc_ncols:
            raise ValueError(f"band column {c} outside the BC table")
        a.band_cols[i] = int(c)
    star_par = lk.star_param_idx.cpu().numpy()
    if star_par.shape != (lk.n_stars, 5) or not (0 <= star_par.min() and star_par.max() < lk.n_params):
        raise ValueError(f"plan array star_param_idx holds an index outside [0, {lk.n_params})")
    for s, row in enumerate(star_par):
        a.star_par[s][:] = [int(c) for c in row]
    _TEMPLATES[lk] = (key, (a, plan))
    return a, plan


def _check_pars(p, lk, name):
    dt, dev = p.dtype, p.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"{name} takes float32 or float64, got {dt}")
    if p.dim() != 2 or p.shape[1] != lk.n_params:
        raise ValueError(f"pars must be (B, {lk.n_params}), got {tuple(p.shape)}")
    return p.contiguous()


def _launch(fn, args, dev, what):
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: {_lib().tree_lnlike_error_string(err).decode()} ({err})")


def _forward(p: torch.Tensor, lk: TreeLikelihood):
    """Kernel C's launch on checked, contiguous ``p``."""
    dt, dev = p.dtype, p.device
    lib = _lib()
    a, _plan = _template(lk, dt, dev)
    B = p.shape[0]
    ll = torch.empty(B, dtype=dt, device=dev)
    orig = torch.empty((B, lk.n_stars), dtype=dt, device=dev)
    deriv = torch.empty((B, lk.n_stars), dtype=dt, device=dev)
    call = _TreeArgs.from_buffer_copy(a)
    call.pars, call.ll, call.orig, call.deriv = p.data_ptr(), ll.data_ptr(), orig.data_ptr(), deriv.data_ptr()
    call.B = B
    _launch(lib.tree_lnlike_f32 if dt == torch.float32 else lib.tree_lnlike_f64, (ctypes.byref(call),), dev,
            "tree_lnlike")
    tree_lnlike_cuda.launches += 1
    return ll, orig, deriv


def tree_lnlike_grad_cuda(p: torch.Tensor, lk: TreeLikelihood, g_ll, g_orig, g_deriv):
    """Kernel C': the gradient ``(B, n_params)`` of ``sum(g_ll * ll + g_orig
    * orig_val + g_deriv * deriv)`` with respect to ``p``, from one launch, by
    the rule of the plain version's autograd (a non-finite output passes no
    gradient). Raises on anything the kernel does not take, and if the launch
    fails."""
    p = _check_pars(p, lk, "tree_lnlike_grad_cuda")
    dt, dev = p.dtype, p.device
    B, S = p.shape[0], lk.n_stars
    cot = []
    for name, g, shape in (("g_ll", g_ll, (B,)), ("g_orig", g_orig, (B, S)), ("g_deriv", g_deriv, (B, S))):
        if tuple(g.shape) != shape or g.dtype != dt or g.device != dev:
            raise ValueError(f"{name} must be {shape} {dt} on {dev}, got {tuple(g.shape)} {g.dtype} on {g.device}")
        cot.append(g.contiguous())
    lib = _lib()
    a, _plan = _template(lk, dt, dev)
    call = _TreeArgs.from_buffer_copy(a)
    call.pars, call.B = p.data_ptr(), B
    out = torch.empty((B, lk.n_params), dtype=dt, device=dev)
    grad = _TreeGradArgs(cot[0].data_ptr(), cot[1].data_ptr(), cot[2].data_ptr(), out.data_ptr())
    _launch(lib.tree_lnlike_grad_f32 if dt == torch.float32 else lib.tree_lnlike_grad_f64,
            (ctypes.byref(call), ctypes.byref(grad)), dev, "tree_lnlike_grad")
    tree_lnlike_grad_cuda.launches += 1
    return out


class TreeLnlike(torch.autograd.Function):
    """Kernel C forward, kernel C' backward."""

    @staticmethod
    def forward(ctx, p, lk):
        ctx.save_for_backward(p)
        ctx.lk = lk
        return _forward(p, lk)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_ll, g_orig, g_deriv):
        (p,) = ctx.saved_tensors
        return tree_lnlike_grad_cuda(p, ctx.lk, g_ll, g_orig, g_deriv), None


def tree_lnlike_cuda(p: torch.Tensor, lk: TreeLikelihood):
    """``(ll (B,), orig_val (B, n_stars), deriv (B, n_stars))`` from one
    kernel launch; where autograd records the call, through
    :class:`TreeLnlike`, whose backward is kernel C'. Raises on anything the
    kernel does not take, and if the launch fails."""
    p = _check_pars(p, lk, "tree_lnlike_cuda")
    if torch.is_grad_enabled() and p.requires_grad:
        return TreeLnlike.apply(p, lk)
    return _forward(p, lk)


#: kernel launches made through each wrapper (reset by callers that count)
tree_lnlike_cuda.launches = 0
tree_lnlike_grad_cuda.launches = 0
