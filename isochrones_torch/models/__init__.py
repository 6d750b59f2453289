from .interpolator import EvolutionTrackInterpolator, IsochroneInterpolator, ModelGridInterpolator

# the reference's models.py module surface: the grid base class and the cgs
# constants (astropy.constants there)
from ..grids.base import StellarModelGrid
from ..utils import G_CGS as G, MSUN_CGS as MSUN, RSUN_CGS as RSUN

__all__ = ["ModelGridInterpolator", "EvolutionTrackInterpolator", "IsochroneInterpolator", "StellarModelGrid", "G",
           "MSUN", "RSUN"]
