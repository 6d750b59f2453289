"""Import path of the reference's ``isochrones/mist/isochrone.py``
(counterpart of ``isochrones_tpu/mist/isochrone.py``): the interpolator
bindings live in the package ``__init__``."""

from . import (
    MIST_BasicEvolutionTrack,
    MIST_BasicIsochrone,
    MIST_EvolutionTrack,
    MIST_Isochrone,
)

__all__ = [
    "MIST_Isochrone",
    "MIST_BasicIsochrone",
    "MIST_EvolutionTrack",
    "MIST_BasicEvolutionTrack",
]
