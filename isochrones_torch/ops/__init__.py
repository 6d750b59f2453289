"""Tensor operations: interpolation, magnitudes, the cluster marginal (plain
version and CUDA kernel wrapper)."""

from .cluster import calc_lnlike_grid, cluster_lnmarginal, cluster_lnmarginal_plain, integrate_over_eeps_ln
from .interp import GridData, compute_axis_maps, corner_data, find_cells_1d, interp_nd
from .mags import interp_mag

__all__ = [
    "GridData",
    "compute_axis_maps",
    "find_cells_1d",
    "corner_data",
    "interp_nd",
    "interp_mag",
    "calc_lnlike_grid",
    "integrate_over_eeps_ln",
    "cluster_lnmarginal_plain",
    "cluster_lnmarginal",
]
