"""isochrones_torch: the PyTorch/CUDA port of ``isochrones_tpu``.

Module names and layout follow the JAX package, so each counterpart sits at
the same relative path. This package imports torch, numpy and scipy only
(never jax, the JAX package or pandas). Ported so far: the cluster MCMC fit
(``StarClusterModel(...).fit_mcmc``) on the synthetic grids, with the
cluster marginal as a hand-written CUDA kernel on the card.
"""

__version__ = "0.1.0"

from .catalog import StarCatalog
from .cluster import StarClusterModel
from .isochrone import get_ichrone
from .ops import GridData, interp_nd

__all__ = ["GridData", "interp_nd", "get_ichrone", "StarCatalog", "StarClusterModel"]
