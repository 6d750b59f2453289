"""Import-path compat: reference ``isochrones/cluster_utils.py`` (counterpart
of ``isochrones_tpu/cluster_utils.py``); the functions live in
:mod:`isochrones_torch.ops.cluster`."""

from .ops.cluster import calc_lnlike_grid, integrate_over_eeps, logaddexp, logsumexp

__all__ = ["logaddexp", "logsumexp", "calc_lnlike_grid", "integrate_over_eeps"]
