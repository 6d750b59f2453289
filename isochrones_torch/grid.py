"""Import-path compat: reference ``isochrones/grid.py`` (counterpart of
``isochrones_tpu/grid.py``); the grid lives in :mod:`isochrones_torch.grids.base`."""

from .grids.base import Grid

__all__ = ["Grid"]
