"""Tensor operations: interpolation and magnitudes (plain torch, and a CUDA
kernel on the card), EEP inversion and root finding (plain torch), the star
likelihood (composed, and fused with a CUDA
kernel on the card), the cluster marginal (plain version, CUDA kernel on the
card)."""

from .eep import get_eep_newton, interp_eep, searchsorted_rows
from .rootfind import find_closest_grid, find_closest_grid_batch
from .cluster import (
    calc_lnlike_grid, cluster_lnlike, cluster_lnmarginal, cluster_lnmarginal_plain, integrate_over_eeps,
    integrate_over_eeps_ln,
)
from .interp import (
    GridData, GridInterpolator, compute_axis_maps, corner_data, find_cells_1d, interp_grid, interp_nd, interp_nd_plain,
)
from .likelihood import LOG_ONE_OVER_ROOT_2PI, gauss_lnprob, stack_components, star_lnlike
from .mags import interp_mag, interp_mag_plain, interp_mags
from .star import StarLikelihood, star_lnlike_fused, star_lnlike_fused_plain

__all__ = [
    "GridData",
    "GridInterpolator",
    "compute_axis_maps",
    "find_cells_1d",
    "corner_data",
    "interp_nd",
    "interp_nd_plain",
    "interp_grid",
    "interp_mag",
    "interp_mag_plain",
    "interp_mags",
    "gauss_lnprob",
    "stack_components",
    "star_lnlike",
    "LOG_ONE_OVER_ROOT_2PI",
    "StarLikelihood",
    "star_lnlike_fused",
    "star_lnlike_fused_plain",
    "calc_lnlike_grid",
    "integrate_over_eeps",
    "integrate_over_eeps_ln",
    "cluster_lnlike",
    "cluster_lnmarginal_plain",
    "cluster_lnmarginal",
    "interp_eep",
    "get_eep_newton",
    "searchsorted_rows",
    "find_closest_grid",
    "find_closest_grid_batch",
]
