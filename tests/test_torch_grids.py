"""Port parity: the synthetic grids and the grid converter.

``isochrones_torch.grids.synthetic.make_synthetic_grids`` runs the JAX
package's numpy code, so in float64 every table, knot vector, axis map and
support array must be bit-identical to the JAX bundle.
"""

import numpy as np
import pytest
import torch

from isochrones_tpu.grids.synthetic import make_synthetic_grids as jax_make_synthetic_grids
from isochrones_torch.convert import grid_from_numpy, grid_from_reference
from isochrones_torch.grids.synthetic import make_synthetic_grids

_DIMS = dict(n_feh=7, n_mass=30, n_eep=100, n_age=30)


@pytest.fixture(scope="module")
def bundles():
    return jax_make_synthetic_grids(**_DIMS), make_synthetic_grids(**_DIMS)


def _same_grid(port, ref):
    assert port.columns == ref.columns
    assert port.axis_maps == ref.axis_maps
    np.testing.assert_array_equal(port.values.numpy(), np.asarray(ref.values))
    np.testing.assert_array_equal(port.host_values, ref.host_values)
    assert len(port.knots) == len(ref.knots)
    for a, b in zip(port.knots, ref.knots):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", ["track", "iso", "bc"])
def test_synthetic_tables_bit_identical(bundles, name):
    ref, port = bundles
    _same_grid(getattr(port, name), getattr(ref, name))
    assert getattr(port, name).values.dtype == torch.float64


def test_synthetic_support_arrays_bit_identical(bundles):
    ref, port = bundles
    for f in ("age_arrays", "dt_deep_arrays", "lengths", "fehs", "masses", "eeps", "ages"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))
    assert port.bands == ref.bands


def test_grid_from_reference_round_trip(bundles):
    ref, _ = bundles
    g = grid_from_reference(ref.iso)
    _same_grid(g, ref.iso)
    # a float32 reference grid keeps its dtype and its (float64-derived) maps
    ref32 = ref.iso.astype(np.float32)
    g32 = grid_from_reference(ref32)
    assert g32.values.dtype == torch.float32
    assert g32.axis_maps == ref.iso.axis_maps
    np.testing.assert_array_equal(g32.values.numpy(), np.asarray(ref32.values))
    # from host arrays, the maps are recomputed from the knots
    g2 = grid_from_numpy(ref.iso.host_values, [np.asarray(k) for k in ref.iso.knots], ref.iso.columns)
    _same_grid(g2, ref.iso)


def test_float32_upload(bundles):
    ref, _ = bundles
    port32 = make_synthetic_grids(**_DIMS, dtype=torch.float32)
    np.testing.assert_array_equal(port32.iso.values.numpy(), ref.iso.host_values.astype(np.float32))
    assert port32.iso.axis_maps == ref.iso.axis_maps


def test_utils_match_reference():
    import isochrones_tpu.utils as ju
    import isochrones_torch.utils as tu

    assert (tu.G_CGS, tu.MSUN_CGS, tu.RSUN_CGS) == (ju.G_CGS, ju.MSUN_CGS, ju.RSUN_CGS)
    a = np.array([10.0, 12.5, 9.0])
    b = np.array([11.0, np.inf, 9.0])  # +inf: no secondary
    np.testing.assert_array_equal(tu.addmags(a, b), ju.addmags(a, b))
    np.testing.assert_array_equal(tu.addmags((10.0, 0.02), (11.0, 0.05)), ju.addmags((10.0, 0.02), (11.0, 0.05)))
