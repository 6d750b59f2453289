"""Import-path compat: reference ``isochrones/version.py`` (counterpart of
``isochrones_tpu/version.py``)."""

from . import __version__

__all__ = ["__version__"]
