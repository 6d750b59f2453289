"""Hand-written CUDA kernels for ``interp_nd`` (kernel B) and its gradient
with respect to the points (kernel B').

Replaces the row-gather path of the JAX package's ``interp_nd``
(``isochrones_tpu/ops/interp.py:483-536``); the source is
``isochrones_torch/csrc/interp_nd.cu``, whose header says what bounds it on
the card and how the design answers that. The plain version it replaces is
:func:`isochrones_torch.ops.interp.interp_nd_plain`.

The wrapper describes the table in one by-value argument struct (axis kinds
and constants, knot pointers, each wanted column's offset within a row);
kernel B runs one lane a point, B' a group of lanes a point whose width the
kernel derives from the batch (the source's note gives the rule). It reads the row layout, or, where the caller asks
for it, a column-planar copy of the wanted columns that it builds once per
table and column tuple (:func:`planar_columns`); both are launches of the
same kernel and count alike. :func:`launch_choice` picks the kernel's
column instance and offset width. Where autograd records a call,
:func:`interp_nd_cuda` goes through :class:`InterpNd`, whose backward is
kernel B'; each wrapper counts its own launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.utils.weak

from ._build import load_library
from ._grad import refuse_grad

__all__ = ["interp_nd_cuda", "interp_nd_grad_cuda", "InterpNd", "launch_choice", "grad_lanes", "planar_columns",
           "MAX_DIM", "MAX_COLS", "EXACT_COLS", "EXACT_MAX_DIM", "CHUNK", "WIDE_ELEMENTS"]

#: the kernels' caps on the grid's axes and on the columns of one call
MAX_DIM = 6
MAX_COLS = 128
#: kernel B's column instances: exactly 1 to EXACT_COLS columns on grids of at
#: most EXACT_MAX_DIM axes, chunks of CHUNK columns otherwise
EXACT_COLS, EXACT_MAX_DIM, CHUNK = 4, 4, 8
#: tables of this many elements or more take 64-bit offsets
WIDE_ELEMENTS = 1 << 31
#: axis-map kind -> the kernel's AxisKind (None: searchsorted)
_KINDS = {None: 0, "exact_affine": 1, "affine": 2, "log": 3, "compare": 4}


class _Axis(ctypes.Structure):
    _fields_ = [("knots", ctypes.c_void_p), ("n", ctypes.c_longlong), ("lo0", ctypes.c_double),
                ("step", ctypes.c_double), ("kind", ctypes.c_int), ("pad", ctypes.c_int)]


class _InterpArgs(ctypes.Structure):
    """Mirror of ``InterpArgs`` in ``csrc/interp_nd.cu`` (checked by size)."""

    _fields_ = [
        ("points", ctypes.c_void_p), ("table", ctypes.c_void_p), ("grad_out", ctypes.c_void_p),
        ("out", ctypes.c_void_p), ("P", ctypes.c_longlong), ("table_len", ctypes.c_longlong), ("ndim", ctypes.c_int),
        ("ncols", ctypes.c_int), ("row_len", ctypes.c_int), ("nc_inst", ctypes.c_int), ("wide", ctypes.c_int),
        ("pad", ctypes.c_int), ("axes", _Axis * MAX_DIM), ("cols", ctypes.c_int * MAX_COLS),
    ]


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel library with the interp entry points' C signatures declared."""
    lib = load_library()
    for name in ("interp_nd_f32", "interp_nd_f64", "interp_nd_grad_f32", "interp_nd_grad_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_InterpArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in ("interp_nd_args_size", "interp_nd_max_dim", "interp_nd_max_cols", "interp_nd_exact_cols",
                 "interp_nd_exact_max_dim", "interp_nd_chunk"):
        getattr(lib, name).restype = ctypes.c_int
    lib.interp_nd_error_string.argtypes = [ctypes.c_int]
    lib.interp_nd_error_string.restype = ctypes.c_char_p
    if lib.interp_nd_args_size() != ctypes.sizeof(_InterpArgs):
        raise RuntimeError(f"InterpArgs layout differs: C {lib.interp_nd_args_size()} bytes, "
                           f"ctypes {ctypes.sizeof(_InterpArgs)}")
    if (lib.interp_nd_max_dim(), lib.interp_nd_max_cols(), lib.interp_nd_exact_cols(), lib.interp_nd_exact_max_dim(),
            lib.interp_nd_chunk()) != (MAX_DIM, MAX_COLS, EXACT_COLS, EXACT_MAX_DIM, CHUNK):
        raise RuntimeError("interp_nd kernel caps or column instances differ from the wrapper's")
    return lib


def launch_choice(table_len: int, ncols: int, ndim: int) -> Tuple[int, bool]:
    """``(column instance, wide)`` for a call on a table of ``table_len``
    elements: 64-bit offsets from :data:`WIDE_ELEMENTS` elements on, the
    exact instance of ``ncols`` columns where there is one (32-bit offsets,
    1 to :data:`EXACT_COLS` columns, at most :data:`EXACT_MAX_DIM` axes),
    else chunks of :data:`CHUNK` columns."""
    wide = table_len >= WIDE_ELEMENTS
    exact = not wide and 1 <= ncols <= EXACT_COLS and ndim <= EXACT_MAX_DIM
    return (ncols if exact else CHUNK), wide


def grad_lanes(n_points: int, ndim: int) -> int:
    """The lanes a point that kernel B' gives ``n_points`` points on a grid of
    ``ndim`` axes (the rule is in the source's note)."""
    fn = _lib().interp_nd_grad_lanes  # declared here: another version's library may lack it
    fn.argtypes, fn.restype = [ctypes.c_longlong, ctypes.c_int], ctypes.c_int
    return fn(int(n_points), int(ndim))


#: column-planar copies by table (weakly: a copy lives as long as its table),
#: then by column tuple
_PLANAR = torch.utils.weak.WeakIdKeyDictionary()


def planar_columns(values: torch.Tensor, icols: Sequence[int]) -> Optional[torch.Tensor]:
    """The columns ``icols`` of the table ``values`` ``(n0, ..., n_{d-1}, C)``
    laid out column-planar, ``(len(icols), n0, ..., n_{d-1})``: a warp's load
    of one column of one corner over neighbouring points is then a run of
    neighbouring values. Built once per table and column tuple, kept while
    the table lives. None where the copy would reach 2**31 elements (the
    kernel's column offsets are 32-bit): such calls read the row layout."""
    icols = tuple(int(c) for c in icols)
    per_table = _PLANAR.setdefault(values, {})
    if icols not in per_table:
        n = len(icols) * (values.numel() // max(1, values.shape[-1]))
        per_table[icols] = None if n >= 1 << 31 else torch.movedim(values[..., list(icols)], -1, 0).contiguous()
    return per_table[icols]


def _args(values, knots, points, icols, axis_maps, name, planar=False) -> Tuple[_InterpArgs, torch.Tensor, torch.Tensor]:
    """The kernel's argument struct (without the output pointers), the
    flattened contiguous points and the table it reads (the row layout, or
    with ``planar`` the column-planar copy of the wanted columns where there
    is one); raises on what the kernel does not take."""
    dt, dev = points.dtype, points.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"{name} takes float32 or float64 points, got {dt}")
    ndim = len(knots)
    if not 1 <= ndim <= MAX_DIM:
        raise ValueError(f"{name} takes grids of 1 to {MAX_DIM} axes (its kernel's cap), got {ndim}")
    if points.shape[-1] != ndim:
        raise ValueError(f"points have {points.shape[-1]} coordinates, the grid {ndim} axes")
    if values.dim() != ndim + 1 or tuple(values.shape[:-1]) != tuple(k.shape[0] for k in knots):
        raise ValueError(f"table shape {tuple(values.shape)} does not match its knots")
    if values.dtype != dt or values.device != dev:
        raise ValueError(f"{name}: the table is {values.dtype} on {values.device}, the points {dt} on {dev}; "
                         f"the kernel takes one dtype and device for both")
    row_len = values.shape[-1]
    icols = tuple(range(row_len)) if icols is None else tuple(int(c) for c in icols)
    if len(icols) > MAX_COLS:
        raise ValueError(f"{name} takes at most {MAX_COLS} columns a call (its kernel's cap), got {len(icols)}")
    if any(not 0 <= c < row_len for c in icols):
        raise ValueError(f"columns {icols} outside the table's {row_len}")
    maps = axis_maps if axis_maps is not None else (None,) * ndim
    a = _InterpArgs()
    for d, (k, amap) in enumerate(zip(knots, maps)):
        if k.device != dev or k.dtype != dt or k.dim() != 1 or not k.is_contiguous() or k.shape[0] < 1:
            raise ValueError(f"{name}: knots must be non-empty contiguous 1-d {dt} tensors on {dev}")
        kind = None if amap is None else amap[0]
        if kind not in _KINDS:
            raise ValueError(f"{name}: axis map {amap!r} is not one the kernel takes")
        lo0, step = (0.0, 0.0) if amap is None else (float(amap[1]), float(amap[2]))
        a.axes[d] = _Axis(k.data_ptr(), k.shape[0], lo0, step, _KINDS[kind], 0)
    table = planar_columns(values, icols) if planar else None
    if table is None:
        table = values.contiguous()
        a.row_len = row_len
        a.cols[:len(icols)] = icols
    else:
        plane = table[0].numel()
        a.row_len = 1
        a.cols[:len(icols)] = [c * plane for c in range(len(icols))]
    pts = points.reshape(-1, ndim).contiguous()
    a.table = table.data_ptr()
    a.table_len = table.numel()
    a.points = pts.data_ptr()
    a.P = pts.shape[0]
    a.ndim = ndim
    a.ncols = len(icols)
    a.nc_inst, wide = launch_choice(a.table_len, a.ncols, ndim)
    a.wide = int(wide)
    return a, pts, table


def _launch(fn, a, dev, what):
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: {_lib().interp_nd_error_string(err).decode()} ({err})")


def _forward(values, knots, points, icols, axis_maps, planar=False):
    """Kernel B's launch: ``(..., n_icols)`` in the points' dtype."""
    a, pts, table = _args(values, knots, points, icols, axis_maps, "interp_nd_cuda", planar)
    out = torch.empty((pts.shape[0], a.ncols), dtype=pts.dtype, device=pts.device)
    if out.numel():
        a.out = out.data_ptr()
        lib = _lib()
        _launch(lib.interp_nd_f32 if pts.dtype == torch.float32 else lib.interp_nd_f64, a, pts.device, "interp_nd")
        interp_nd_cuda.launches += 1
    return out.reshape(points.shape[:-1] + (a.ncols,))


def interp_nd_grad_cuda(values, knots, points, grad_out, icols=None, axis_maps=None) -> torch.Tensor:
    """Kernel B': the gradient ``points.shape`` of ``sum(grad_out *
    interp_nd(values, knots, points, icols, axis_maps))`` with respect to the
    points, from one launch, by the plain version's autograd rule (dt/dx is
    ``1 / step`` or ``1 / (hi - lo)``, 0 where t is a constant; a NaN value
    or a bad point passes no gradient). Raises on anything the kernel does
    not take, and if the launch fails."""
    a, pts, table = _args(values, knots, points, icols, axis_maps, "interp_nd_grad_cuda")
    want = points.shape[:-1] + (a.ncols,)
    if tuple(grad_out.shape) != tuple(want) or grad_out.dtype != pts.dtype or grad_out.device != pts.device:
        raise ValueError(f"grad_out must be {tuple(want)} {pts.dtype} on {pts.device}, got "
                         f"{tuple(grad_out.shape)} {grad_out.dtype} on {grad_out.device}")
    g = grad_out.reshape(-1, a.ncols).contiguous()
    out = torch.zeros_like(pts)
    if pts.shape[0] and a.ncols:
        a.grad_out = g.data_ptr()
        a.out = out.data_ptr()
        lib = _lib()
        _launch(lib.interp_nd_grad_f32 if pts.dtype == torch.float32 else lib.interp_nd_grad_f64, a, pts.device,
                "interp_nd_grad")
        interp_nd_grad_cuda.launches += 1
    return out.reshape(points.shape)


class InterpNd(torch.autograd.Function):
    """Kernel B forward, kernel B' backward (gradient of the points only)."""

    @staticmethod
    def forward(ctx, points, values, knots, icols, axis_maps, planar):
        ctx.save_for_backward(points)
        ctx.grid = (values, knots, icols, axis_maps)
        return _forward(values, knots, points, icols, axis_maps, planar)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        (points,) = ctx.saved_tensors
        values, knots, icols, axis_maps = ctx.grid
        return interp_nd_grad_cuda(values, knots, points, grad_out, icols, axis_maps), None, None, None, None, None


def interp_nd_cuda(
    values: torch.Tensor,
    knots: Sequence[torch.Tensor],
    points: torch.Tensor,
    icols: Optional[Tuple[int, ...]] = None,
    axis_maps: Optional[Tuple] = None,
    planar: bool = False,
) -> torch.Tensor:
    """``interp_nd`` from one launch of kernel B: ``(..., n_icols)``, NaN rows
    for NaN or out-of-bounds points. With ``planar`` the kernel reads the
    column-planar copy of these columns (:func:`planar_columns`) instead of
    the row layout. Where autograd records the call, through :class:`InterpNd`,
    whose backward is kernel B' (the points' gradient; the table and knots
    take none, and the call raises if they ask for one). Raises on anything
    the kernel does not take, and if the launch fails."""
    knots = tuple(knots)
    refuse_grad("interp_nd_cuda (table, knots)", values, *knots)
    if torch.is_grad_enabled() and points.requires_grad:
        return InterpNd.apply(points, values, knots, icols, axis_maps, planar)
    return _forward(values, knots, points, icols, axis_maps, planar)


#: kernel launches made through each wrapper (reset by callers that count)
interp_nd_cuda.launches = 0
interp_nd_grad_cuda.launches = 0
