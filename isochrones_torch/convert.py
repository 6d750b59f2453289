"""Carry grid tables ("the weights" of this system) into the port.

``grid_from_numpy`` builds a :class:`~isochrones_torch.ops.interp.GridData`
from host arrays; ``grid_from_reference`` reads a grid of the JAX package by
duck typing (``host_values``/``values``, ``knots``, ``columns``,
``axis_maps``) without importing JAX, so one and the same table can be put
into both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.interp import GridData, compute_axis_maps

__all__ = ["grid_from_numpy", "grid_from_reference"]


def grid_from_numpy(values, knots, columns, axis_maps=None, device="cpu", dtype=torch.float64):
    """GridData on ``device`` in ``dtype`` from host arrays. ``axis_maps``
    default to :func:`compute_axis_maps` of the float64 knots."""
    values = np.asarray(values)
    knots = tuple(np.asarray(k, dtype=np.float64) for k in knots)
    if axis_maps is None:
        axis_maps = compute_axis_maps(knots)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    host = np.ascontiguousarray(values, dtype=np_dtype)
    return GridData(
        values=torch.as_tensor(host, device=device),
        knots=tuple(torch.as_tensor(k.astype(np_dtype), device=device) for k in knots),
        columns=tuple(columns),
        host_values=host,
        axis_maps=tuple(axis_maps),
    )


def grid_from_reference(g, device="cpu", dtype=None):
    """GridData from a JAX-package grid ``g``; ``dtype`` defaults to the
    dtype of its values."""
    values = np.asarray(g.host_values if g.host_values is not None else g.values)
    if dtype is None:
        dtype = torch.from_numpy(np.zeros(0, dtype=values.dtype)).dtype
    return grid_from_numpy(
        values, [np.asarray(k) for k in g.knots], g.columns,
        axis_maps=g.axis_maps, device=device, dtype=dtype,
    )
