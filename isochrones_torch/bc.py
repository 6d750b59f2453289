"""Import-path compat: reference ``isochrones/bc.py`` (counterpart of
``isochrones_tpu/bc.py``); the grid lives in :mod:`isochrones_torch.grids.base`."""

from .grids.base import BolometricCorrectionGrid

__all__ = ["BolometricCorrectionGrid"]
