"""Import-path compat: reference ``isochrones/mags.py`` (counterpart of
``isochrones_tpu/mags.py``); the functions live in :mod:`isochrones_torch.ops.mags`."""

from .ops.mags import interp_mag, interp_mags

__all__ = ["interp_mag", "interp_mags"]
