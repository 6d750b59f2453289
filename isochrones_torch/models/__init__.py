from .interpolator import EvolutionTrackInterpolator, IsochroneInterpolator, ModelGridInterpolator

__all__ = ["ModelGridInterpolator", "EvolutionTrackInterpolator", "IsochroneInterpolator"]
