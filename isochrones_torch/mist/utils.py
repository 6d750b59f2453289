"""Import path of the reference's ``isochrones/mist/utils.py`` (counterpart
of ``isochrones_tpu/mist/utils.py``): the max-EEP helpers, as in
``mist/eep.py``."""

from ..grids.mist_eep import default_max_eep, max_eep

__all__ = ["default_max_eep", "max_eep"]
