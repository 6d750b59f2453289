"""Interpolator factory (counterpart of ``isochrones_tpu/isochrone.py``,
reference ``isochrones/isochrone.py:48-78``).

``get_ichrone("mist")`` (the default, as in the reference) builds the MIST
grids from their files under ``$ISOCHRONES`` (``config.ISOCHRONES``; nothing
is downloaded: a missing file raises
:class:`~isochrones_torch.grids.base.MissingGridError` naming its path), and
``get_ichrone("synthetic")`` the hermetic analytic grids. Each returns one of
a cross-linked isochrone/track interpolator pair, built once per
configuration.
"""

from __future__ import annotations

import torch

from .models import EvolutionTrackInterpolator, IsochroneInterpolator

__all__ = ["get_ichrone"]

#: synthetic grid bundles and the interpolator pairs built on them, one per
#: (bands, dtype, device, grid sizes): two calls share one set of tables
_synthetic_cache = {}
#: MIST interpolator pairs, one per (data directory, bands, basic, dtype,
#: device, grid keywords)
_mist_cache = {}


def _build_synthetic(bands=None, dtype=torch.float64, device="cuda", **kwargs):
    """The cached ``(grids, iso, track)`` of one synthetic configuration."""
    from .grids.synthetic import make_synthetic_grids

    key = (tuple(bands) if bands else None, str(dtype), str(torch.device(device)), tuple(sorted(kwargs.items())))
    if key not in _synthetic_cache:
        if bands:
            kwargs = dict(kwargs, bands=bands)
        g = make_synthetic_grids(device=device, dtype=dtype, **kwargs)
        names = bands or list(g.bands)
        dev = g.track.values.device
        eep_support = (
            g.track.knots[0],
            g.track.knots[1],
            torch.as_tensor(g.age_arrays, dtype=dtype, device=dev),
            torch.as_tensor(g.lengths, dtype=torch.int64, device=dev),
        )
        track = EvolutionTrackInterpolator(g.track, g.bc, bands=names, eep_support=eep_support)
        iso = IsochroneInterpolator(g.iso, g.bc, bands=names, track=track)
        track._iso = iso
        _synthetic_cache[key] = (g, iso, track)
    return _synthetic_cache[key]


def get_ichrone(models="mist", bands=None, tracks=False, basic=False, device="cuda", dtype=torch.float64, **kwargs):
    """Build a model-grid interpolator by name (reference isochrone.py:48-78)
    on ``device`` (the card unless the caller passes ``device="cpu"``; torch
    raises without one) in ``dtype``.

    models : "mist" (the MIST grids from their files under ``$ISOCHRONES``;
        ``version``, ``vvcrit``, ``kind`` and ``afe`` in ``kwargs``) or
        "synthetic" (the hermetic analytic grids, sized by ``n_feh``,
        ``n_mass``, ``n_eep``, ``n_age`` in ``kwargs``); an interpolator
        instance is returned as it is
    tracks : return the evolution-track interpolator instead of the isochrone
        one; each links to the other (``iso.track``, ``track.iso``)
    basic : the MIST ``basic_isos`` isochrones (fewer columns), as in the
        reference
    """
    if isinstance(models, (IsochroneInterpolator, EvolutionTrackInterpolator)):
        return models

    if models == "synthetic":
        _, iso, track = _build_synthetic(bands=bands, dtype=dtype, device=device, **kwargs)
        return track if tracks else iso

    if models == "mist":
        from . import config
        from .grids.mist import get_mist_interpolators

        key = (config.ISOCHRONES, tuple(bands) if bands else None, bool(basic), str(dtype),
               str(torch.device(device)), tuple(sorted(kwargs.items())))
        if key not in _mist_cache:
            _mist_cache[key] = get_mist_interpolators(bands=bands, basic=basic, device=device, dtype=dtype,
                                                      **kwargs)
        iso, track = _mist_cache[key]
        return track if tracks else iso

    raise ValueError(f"Unknown model grid: {models!r} (available: 'mist', 'synthetic')")
