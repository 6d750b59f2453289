"""Import path of the reference's ``isochrones/mist/bc.py`` (counterpart of
``isochrones_tpu/mist/bc.py``): ``MISTBolometricCorrectionGrid`` lives in
:mod:`isochrones_torch.grids.mist`."""

from ..grids.mist import MISTBolometricCorrectionGrid

__all__ = ["MISTBolometricCorrectionGrid"]
