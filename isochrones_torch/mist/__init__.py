"""MIST interpolator bindings (counterpart of ``isochrones_tpu/mist/__init__.py``).

Reference ``isochrones/mist/isochrone.py:6-33`` (``MIST_Isochrone``,
``MIST_BasicIsochrone``, ``MIST_EvolutionTrack``): named constructors of the
cross-linked isochrone/track interpolator pairs over the MIST grids read from
``$ISOCHRONES``. Factory functions rather than subclasses: the interpolators
are configured by their grids. Each takes ``device`` (the card unless the
caller passes ``device="cpu"``) and ``dtype`` as ``get_ichrone`` does.
"""

from __future__ import annotations

from ..grids.mist import (
    MISTBasicIsochroneGrid,
    MISTBolometricCorrectionGrid,
    MISTEvolutionTrackGrid,
    MISTIsochroneGrid,
    get_mist_interpolators,
)
from ..grids.mist_eep import max_eep

__all__ = [
    "MIST_Isochrone",
    "MIST_BasicIsochrone",
    "MIST_EvolutionTrack",
    "MIST_BasicEvolutionTrack",
    "MISTIsochroneGrid",
    "MISTEvolutionTrackGrid",
    "MISTBolometricCorrectionGrid",
    "max_eep",
]


def MIST_Isochrone(bands=None, **kwargs):
    """Isochrone-parameterized MIST interpolator (eep, age, feh, distance, AV)."""
    iso, _ = get_mist_interpolators(bands=bands, **kwargs)
    return iso


def _bind_class_hooks(factory, grid_type, basic=False):
    """Mirror the reference's class attributes (mist/isochrone.py:6-33) on
    the factory functions; instances get the same hooks from their grids."""
    factory.grid_type = grid_type
    factory.bc_type = MISTBolometricCorrectionGrid
    factory.eep_bounds = (0, 1710)
    factory.basic = basic


def MIST_BasicIsochrone(bands=None, **kwargs):
    """Same over the basic_isos tables (reference mist/isochrone.py:16-18)."""
    iso, _ = get_mist_interpolators(bands=bands, basic=True, **kwargs)
    return iso


def MIST_EvolutionTrack(bands=None, **kwargs):
    """Track-parameterized MIST interpolator (mass, eep, feh, distance, AV)."""
    _, track = get_mist_interpolators(bands=bands, **kwargs)
    return track


def MIST_BasicEvolutionTrack(bands=None, **kwargs):
    """Track interpolator over the basic-isochrone pairing (reference
    mist/isochrone.py:29: MIST_BasicEvolutionTrack <-> MIST_BasicIsochrone)."""
    _, track = get_mist_interpolators(bands=bands, basic=True, **kwargs)
    return track


_bind_class_hooks(MIST_Isochrone, MISTIsochroneGrid)
_bind_class_hooks(MIST_BasicIsochrone, MISTBasicIsochroneGrid, basic=True)
_bind_class_hooks(MIST_EvolutionTrack, MISTEvolutionTrackGrid)
_bind_class_hooks(MIST_BasicEvolutionTrack, MISTEvolutionTrackGrid, basic=True)
