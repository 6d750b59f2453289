"""Interpolator factory (counterpart of ``isochrones_tpu/isochrone.py``).

Only the hermetic analytic grids are ported: ``get_ichrone("synthetic")``;
``get_ichrone("mist")`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from .models import IsochroneInterpolator

__all__ = ["get_ichrone"]


def get_ichrone(models="synthetic", bands=None, device="cuda", dtype=torch.float64, **kwargs):
    """Build the isochrone interpolator on ``device`` (the card unless the
    caller passes ``device="cpu"``; torch raises without one) in ``dtype``.
    ``kwargs`` size the synthetic grids (``n_feh``, ``n_mass``, ``n_eep``,
    ``n_age``)."""
    if models == "mist":
        raise NotImplementedError("the real MIST grids need their data files, which this port does not read yet "
                                  "(ROADMAP queue 1); use models='synthetic'")
    if models != "synthetic":
        raise ValueError(f"Unknown model grid: {models!r} (available: 'synthetic')")
    from .grids.synthetic import make_synthetic_grids

    if bands:
        kwargs["bands"] = bands
    g = make_synthetic_grids(device=device, dtype=dtype, **kwargs)
    return IsochroneInterpolator(g.iso, g.bc, bands=bands or list(g.bands))
