"""Carry grid tables ("the weights" of this system) into the port.

``grid_from_numpy`` builds a :class:`~isochrones_torch.ops.interp.GridData`
from host arrays; ``grid_from_reference`` reads a grid of the JAX package by
duck typing (``host_values``/``values``, ``knots``, ``columns``,
``axis_maps``) without importing JAX, so one and the same table can be put
into both packages. ``plan_from_reference`` and ``segments_from_reference``
do the same for the JAX package's compiled tree plan and its nested-sampling
segments: tests hand them over as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.interp import GridData, compute_axis_maps

__all__ = ["grid_from_numpy", "grid_from_reference", "plan_from_reference", "segments_from_reference"]


def grid_from_numpy(values, knots, columns, axis_maps=None, device="cuda", dtype=torch.float64):
    """GridData on ``device`` (the card unless the caller passes
    ``device="cpu"``; torch raises without one) in ``dtype`` from host
    arrays. ``axis_maps`` default to :func:`compute_axis_maps` of the float64
    knots."""
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


def grid_from_reference(g, device="cuda", dtype=None):
    """GridData from a JAX-package grid ``g``; ``dtype`` defaults to the
    dtype of its values."""
    values = np.asarray(g.host_values if g.host_values is not None else g.values)
    if dtype is None:
        dtype = torch.from_numpy(np.zeros(0, dtype=values.dtype)).dtype
    return grid_from_numpy(
        values, [np.asarray(k) for k in g.knots], g.columns,
        axis_maps=g.axis_maps, device=device, dtype=dtype,
    )


def plan_from_reference(plan, ic):
    """The port's :class:`~isochrones_torch.observation.TreePlan` from a
    compiled plan of the JAX package (its fields are numpy arrays, tuples and
    ints), bound to the port's interpolator ``ic``."""
    import dataclasses

    from .observation import TreePlan

    fields = {}
    for f in dataclasses.fields(TreePlan):
        if f.name == "ic":
            continue
        v = getattr(plan, f.name)
        fields[f.name] = np.array(v) if isinstance(v, np.ndarray) else (int(v) if f.name == "n_params" else tuple(v))
    return TreePlan(ic=ic, **fields)


def segments_from_reference(segments):
    """Nested-sampling segments of the JAX package (dicts of ``dead_lnl``,
    ``live_lnl``, ``all_u``, ``n_live``, ``n_batch``, ``L0``, possibly device
    arrays) as the numpy input of the port's ``_merge_segments``."""
    return [dict(dead_lnl=np.asarray(s["dead_lnl"], dtype=float), live_lnl=np.asarray(s["live_lnl"], dtype=float),
                 all_u=np.asarray(s["all_u"], dtype=float), n_live=int(s["n_live"]),
                 n_batch=int(s.get("n_batch", 1)), L0=float(s["L0"])) for s in segments]
