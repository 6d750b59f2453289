"""Reference-named interpolation API (counterpart of ``isochrones_tpu/interp.py``).

Drop-in equivalents of the public names of the reference's numba kernel
module (``isochrones/interp.py``), so code written against the reference
imports unchanged::

    from isochrones_torch.interp import DFInterpolator, interp_value_3d

Host wrappers that take and return numpy: the scalar index utilities run in
plain numpy; the value and EEP interpolators and ``find_closest3`` hand their
arrays, as float64 tensors on ``device`` (the card unless the caller passes
``device="cpu"``), to the batched torch operations of
:mod:`isochrones_torch.ops` (``interp_nd``, ``interp_eep``,
``find_closest_grid``). The semantics are the reference's (cell location,
NaN and out-of-bounds handling, end-of-track neighbour substitution) but for
exact top-knot queries (``ops.interp.REFERENCE_DEVIATIONS``).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.interp import GridData, GridInterpolator, compute_axis_maps, interp_nd  # noqa: F401  (re-exported)

__all__ = [
    "DFInterpolator",
    "searchsorted",
    "find_indices",
    "find_indices_2d",
    "find_indices_3d",
    "find_indices_4d",
    "interp_value_2d",
    "interp_value_3d",
    "interp_value_4d",
    "interp_values_2d",
    "interp_values_3d",
    "interp_values_4d",
    "sign",
    "find_closest3",
    "interp_eep",
    "interp_eeps",
]

#: The reference's ``DFInterpolator`` (interp.py:571-698) is
#: :class:`~isochrones_torch.ops.interp.GridInterpolator`: built from a table
#: with a multi-level index, densified to a NaN-padded grid, called with
#: ``(p, cols)``.
DFInterpolator = GridInterpolator


def _tensor(x, device, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x, dtype=float), dtype=dtype, device=device)


def searchsorted(arr, x, N=-1):
    """Binary search returning ``(index, exact_match)`` (reference
    interp.py:10-36)."""
    arr = np.asarray(arr)
    if N == -1:
        N = len(arr)
    L = int(np.searchsorted(arr[:N], x, side="left"))
    return L, bool(L < N and arr[L] == x)


def _find_indices_nd(xs, iis):
    # zero-initialized as the reference's variants, so an out-of-bounds
    # dimension reports (0, 0.0) rather than uninitialized memory
    ndim = len(xs)
    indices = np.zeros(ndim, dtype=np.uint32)
    norm = np.zeros(ndim, dtype=np.float64)
    oob = False
    for i, (x, ii) in enumerate(zip(xs, iis)):
        ii = np.asarray(ii, dtype=float)
        if x < ii[0] or x > ii[-1]:
            oob = True
            continue
        ix, eq = searchsorted(ii, x)
        if eq:
            indices[i] = ix
            norm[i] = 0.0
        else:
            indices[i] = ix - 1
            c0 = ii[ix - 1]
            norm[i] = (x - c0) / (ii[ix] - c0)
    return indices, norm, oob


def find_indices(point, iis):
    """Cell indices and normalized distances of one N-d point (reference
    interp.py:38-61; its out-of-bounds flag is computed here, where the
    reference's ``&=`` accumulator can never become True)."""
    return _find_indices_nd(list(point), list(iis))


def find_indices_2d(x0, x1, ii0, ii1):
    """reference interp.py:63-94"""
    return _find_indices_nd((x0, x1), (ii0, ii1))


def find_indices_3d(x0, x1, x2, ii0, ii1, ii2):
    """reference interp.py:96-144"""
    return _find_indices_nd((x0, x1, x2), (ii0, ii1, ii2))


def find_indices_4d(x0, x1, x2, x3, ii0, ii1, ii2, ii3):
    """reference interp.py:146-205"""
    return _find_indices_nd((x0, x1, x2, x3), (ii0, ii1, ii2, ii3))


def _interp_values(xs, grid, icols, iis, device):
    knots = tuple(np.asarray(ii, dtype=float) for ii in iis)
    shape = np.broadcast(*xs).shape
    # broadcast_to, not resize: resize fills cyclically, wrong for 2-d
    # broadcasts such as (3, 1) x (1, 4)
    pts = np.stack([np.broadcast_to(np.asarray(x, dtype=float), shape).ravel() for x in xs], axis=-1)
    out = interp_nd(_tensor(grid, device), tuple(_tensor(k, device) for k in knots), _tensor(pts, device),
                    icols=tuple(int(i) for i in np.atleast_1d(icols)), axis_maps=compute_axis_maps(knots))
    return out.cpu().numpy()


def interp_value_2d(x0, x1, grid, icols, ii0, ii1, device="cuda"):
    """reference interp.py:208-250"""
    return _interp_values((x0, x1), grid, icols, (ii0, ii1), device)[0]


def interp_value_3d(x0, x1, x2, grid, icols, ii0, ii1, ii2, device="cuda"):
    """reference interp.py:252-294"""
    return _interp_values((x0, x1, x2), grid, icols, (ii0, ii1, ii2), device)[0]


def interp_value_4d(x0, x1, x2, x3, grid, icols, ii0, ii1, ii2, ii3, device="cuda"):
    """reference interp.py:296-339"""
    return _interp_values((x0, x1, x2, x3), grid, icols, (ii0, ii1, ii2, ii3), device)[0]


def interp_values_2d(xx0, xx1, grid, icols, ii0, ii1, device="cuda"):
    """reference interp.py:341-357"""
    return _interp_values((xx0, xx1), grid, icols, (ii0, ii1), device)


def interp_values_3d(xx0, xx1, xx2, grid, icols, ii0, ii1, ii2, device="cuda"):
    """reference interp.py:359-376"""
    return _interp_values((xx0, xx1, xx2), grid, icols, (ii0, ii1, ii2), device)


def interp_values_4d(xx0, xx1, xx2, xx3, grid, icols, ii0, ii1, ii2, ii3, device="cuda"):
    """reference interp.py:378-393"""
    return _interp_values((xx0, xx1, xx2, xx3), grid, icols, (ii0, ii1, ii2, ii3), device)


def sign(x):
    """reference interp.py:395-401 (``sign(0) == 1`` there, kept)."""
    return -1 if x < 0 else 1


def find_closest3(val, lo, hi, v1, v2, grid, icol, ii0, ii1, ii2, debug=False, device="cuda"):
    """Root along the third grid axis (reference interp.py:404-485), by the
    capped bisection + secant of :mod:`isochrones_torch.ops.rootfind`."""
    from .ops.rootfind import find_closest_grid

    knots = tuple(np.asarray(ii, dtype=float) for ii in (ii0, ii1, ii2))
    grid = np.asarray(grid, dtype=float)
    gd = GridData(values=_tensor(grid, device), knots=tuple(_tensor(k, device) for k in knots),
                  columns=tuple(str(i) for i in range(grid.shape[-1])), axis_maps=compute_axis_maps(knots))
    return float(find_closest_grid(gd, val, lo, hi, v1, v2, int(icol)))


def interp_eep(x, x0, x1, ii0, ii1, n1, arrays, weight_arrays, lengths, device="cuda"):
    """Fast (age, feh, mass) -> EEP inversion of one point (reference
    interp.py:502-558). ``weight_arrays`` is taken for the signature: the
    reference computes weights from it but never uses them in its blend
    (interp.py:546-556)."""
    return float(interp_eeps([x], [x0], [x1], ii0, ii1, n1, arrays, weight_arrays, lengths, device=device)[0])


def interp_eeps(xs, x0s, x1s, ii0, ii1, n1, arrays, weight_arrays, lengths, device="cuda"):
    """Batched fast EEP inversion (reference interp.py:488-500)."""
    from .ops.eep import interp_eep as _interp_eep_batch

    del n1, weight_arrays  # from the shapes / unused (see interp_eep)
    out = _interp_eep_batch(_tensor(xs, device), _tensor(x0s, device), _tensor(x1s, device), _tensor(ii0, device),
                            _tensor(ii1, device), _tensor(arrays, device),
                            torch.as_tensor(np.asarray(lengths), device=device), eep0=1.0)
    return out.cpu().numpy()
