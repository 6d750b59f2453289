from .interpolator import IsochroneInterpolator, ModelGridInterpolator

__all__ = ["ModelGridInterpolator", "IsochroneInterpolator"]
