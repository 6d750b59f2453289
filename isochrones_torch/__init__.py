"""isochrones_torch: the PyTorch/CUDA port of ``isochrones_tpu``.

Module names and layout follow the JAX package, so each counterpart sits at
the same relative path. This package imports torch, numpy and scipy only
(never jax, the JAX package, pandas or h5py). Ported so far, on the
synthetic grids: the ``starfit`` entry point (``isochrones_torch.starfit``,
``python -m isochrones_torch.cli.starfit``: a folder with a ``star.ini`` ->
flat or tree model -> nested fit, static or dynamic, with checkpoint and
resume -> a results file); the single/binary/triple star models, the fused
star likelihood as a hand-written CUDA kernel on the card; the tree
``StarModel`` for resolved and blended systems, its likelihood as a second
kernel; and the cluster MCMC fit (``StarClusterModel(...).fit_mcmc``), the
cluster marginal as a third.
"""

__version__ = "0.1.0"

from .catalog import StarCatalog
from .cluster import StarClusterModel
from .isochrone import get_ichrone
from .ops import GridData, interp_nd
from .starmodel import BasicStarModel, BinaryStarModel, SingleStarModel, TripleStarModel
from .treemodel import StarModel, StarModelGroup

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
    "StarModel",
    "StarModelGroup",
]
