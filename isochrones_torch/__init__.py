"""isochrones_torch: the PyTorch/CUDA port of ``isochrones_tpu``.

Module names and layout follow the JAX package, so each counterpart sits at
the same relative path. This package imports torch, numpy and scipy only
(never jax, the JAX package or pandas). Ported so far, on the synthetic
grids: the single/binary/triple star models with their nested-sampling fit
(``BinaryStarModel(...).fit_multinest``), the fused star likelihood as a
hand-written CUDA kernel on the card; and the cluster MCMC fit
(``StarClusterModel(...).fit_mcmc``), the cluster marginal as a second
CUDA kernel.
"""

__version__ = "0.1.0"

from .catalog import StarCatalog
from .cluster import StarClusterModel
from .isochrone import get_ichrone
from .ops import GridData, interp_nd
from .starmodel import BasicStarModel, BinaryStarModel, SingleStarModel, TripleStarModel

__all__ = [
    "GridData",
    "interp_nd",
    "get_ichrone",
    "StarCatalog",
    "StarClusterModel",
    "BasicStarModel",
    "SingleStarModel",
    "BinaryStarModel",
    "TripleStarModel",
]
