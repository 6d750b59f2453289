"""Import path of the reference's ``isochrones/mist/models.py`` (counterpart
of ``isochrones_tpu/mist/models.py``): the grid classes live in
:mod:`isochrones_torch.grids.mist`."""

from ..grids.mist import (
    MISTBasicIsochroneGrid,
    MISTEvolutionTrackGrid,
    MISTIsochroneGrid,
    MISTModelGrid,
)

__all__ = [
    "MISTModelGrid",
    "MISTIsochroneGrid",
    "MISTBasicIsochroneGrid",
    "MISTEvolutionTrackGrid",
]
