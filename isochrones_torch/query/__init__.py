"""External catalog queries (counterpart of ``isochrones_tpu/query/``).

The sky math is numpy, a result table is a :class:`~isochrones_torch.summary.Frame`,
and the network layer (astroquery's Vizier) is optional and imported only
when a query runs without an injected ``table_provider``.
"""

from .catalog import Catalog
from .query import EmptyQueryError, Query
from .vizier import Gaia, TwoMASS, Tycho2, VizierCatalog, WISE

__all__ = [
    "Query", "EmptyQueryError", "Catalog", "VizierCatalog",
    "TwoMASS", "Tycho2", "WISE", "Gaia",
]
