"""Import path of the reference's ``isochrones/mist/eep.py`` (counterpart of
``isochrones_tpu/mist/eep.py``): the max-EEP truncation table lives in
:mod:`isochrones_torch.grids.mist_eep`."""

from ..grids.mist_eep import default_max_eep, max_eep

__all__ = ["default_max_eep", "max_eep"]
