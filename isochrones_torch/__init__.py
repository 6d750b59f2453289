"""isochrones_torch: the PyTorch/CUDA port of ``isochrones_tpu``.

Module names and layout follow the JAX package, so each counterpart sits at
the same relative path. This package imports torch, numpy and scipy only
(never jax, the JAX package, pandas or h5py). The grids: ``get_ichrone("mist")``
reads the MIST files under ``$ISOCHRONES`` (``grids/mist.py``, ``mist/``;
nothing is downloaded; ``python -m isochrones_torch.cli.initialize`` builds
their caches) and ``get_ichrone("synthetic")`` builds the hermetic analytic
grids. Ported so far, on either: the ``starfit`` entry point (``isochrones_torch.starfit``,
``python -m isochrones_torch.cli.starfit``: a folder with a ``star.ini`` ->
flat or tree model -> nested fit, static or dynamic, with checkpoint and
resume -> a results file); the single/binary/triple star models, the fused
star likelihood as a hand-written CUDA kernel on the card; the tree
``StarModel`` for resolved and blended systems, its likelihood as a second
kernel; the cluster model (``StarClusterModel``: nested fit, dynamic by
default, and MCMC fit; ``python -m isochrones_torch.cli.clusterfit`` on a CSV
table of members), the cluster marginal as a third kernel; EEP inversion
(``get_eep``) on the cross-linked isochrone and evolution-track interpolators
and the cluster simulator (``SimulatedCluster``), in plain torch; whole-catalog
fitting (``isochrones_torch.batch``: ``BatchStarFitter``, ``fit_catalog``,
every star's MCMC or nested fit in lockstep, with ``summary.summarize_batch``
and ``python -m isochrones_torch.cli.fit_catalog``), the catalog likelihood as
a fourth kernel; the forward model (the interpolators' ``generate``,
``generate_device``, ``generate_binary``, ``isochrone``, ``model_value``,
``model_mag``), population synthesis (``StarPopulation``, ``deredden``) and
``python -m isochrones_torch.cli.generate_cmd``, the forward model and the
fast EEP inversion as a fifth kernel; the joint isochrone + track model
(``IsoTrackModel``), its posterior two launches of the star kernel; the
Gaia-conditioned ``starfit`` (``query``), the corner plots (``plotting``),
the per-folder summaries (``summary``) and the ``summarize`` and ``select``
CLIs, which import matplotlib, astroquery and requests only when called; the
device mesh that splits every fit engine's likelihood fan-out and the
cluster's star axis over devices, and the fleets of processes behind the
CLIs' ``--multihost`` (``parallel``).
"""

__version__ = "0.1.0"

from .catalog import StarCatalog
from .cluster import SimulatedCluster, StarClusterModel, clusterfit, simulate_cluster
from .isochrone import get_ichrone
from .ops import GridData, GridInterpolator, interp_nd
from .populations import (
    BinaryDistribution, StarFormationHistory, StarFormationHistoryGrid, StarPopulation, deredden,
)
from .starmodel import BasicStarModel, BinaryStarModel, IsoTrackModel, SingleStarModel, TripleStarModel
from .treemodel import StarModel, StarModelGroup

__all__ = [
    "GridData",
    "GridInterpolator",
    "interp_nd",
    "get_ichrone",
    "StarCatalog",
    "StarClusterModel",
    "SimulatedCluster",
    "simulate_cluster",
    "clusterfit",
    "BasicStarModel",
    "SingleStarModel",
    "BinaryStarModel",
    "TripleStarModel",
    "IsoTrackModel",
    "StarModel",
    "StarModelGroup",
    "StarPopulation",
    "StarFormationHistory",
    "StarFormationHistoryGrid",
    "BinaryDistribution",
    "deredden",
]
