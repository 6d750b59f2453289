"""Port parity: the synthetic grids and the grid converter.

``isochrones_torch.grids.synthetic.make_synthetic_grids`` runs the JAX
package's numpy code, so in float64 every table, knot vector, axis map and
support array must be bit-identical to the JAX bundle.
"""

import os
import re

import numpy as np
import pytest
import torch

from isochrones_tpu.grids.synthetic import make_synthetic_grids as jax_make_synthetic_grids
from isochrones_torch.convert import grid_from_numpy, grid_from_reference
from isochrones_torch.grids.synthetic import make_synthetic_grids

_DIMS = dict(n_feh=7, n_mass=30, n_eep=100, n_age=30)


@pytest.fixture(scope="module")
def bundles():
    return jax_make_synthetic_grids(**_DIMS), make_synthetic_grids(device="cpu", **_DIMS)


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
    g = grid_from_reference(ref.iso, device="cpu")
    _same_grid(g, ref.iso)
    # a float32 reference grid keeps its dtype and its (float64-derived) maps
    ref32 = ref.iso.astype(np.float32)
    g32 = grid_from_reference(ref32, device="cpu")
    assert g32.values.dtype == torch.float32
    assert g32.axis_maps == ref.iso.axis_maps
    np.testing.assert_array_equal(g32.values.numpy(), np.asarray(ref32.values))
    # from host arrays, the maps are recomputed from the knots
    g2 = grid_from_numpy(ref.iso.host_values, [np.asarray(k) for k in ref.iso.knots], ref.iso.columns, device="cpu")
    _same_grid(g2, ref.iso)


def test_float32_upload(bundles):
    ref, _ = bundles
    port32 = make_synthetic_grids(device="cpu", **_DIMS, dtype=torch.float32)
    np.testing.assert_array_equal(port32.iso.values.numpy(), ref.iso.host_values.astype(np.float32))
    assert port32.iso.axis_maps == ref.iso.axis_maps


@pytest.mark.parametrize("entry", ["get_ichrone", "make_synthetic_grids", "grid_from_numpy", "grid_from_reference"])
def test_entry_points_default_to_the_card(bundles, entry):
    """Without ``device=`` the port builds on the card; with no card that
    raises instead of building on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    from isochrones_torch import get_ichrone

    ref, _ = bundles
    calls = {
        "get_ichrone": lambda: get_ichrone("synthetic", **_DIMS),
        "make_synthetic_grids": lambda: make_synthetic_grids(**_DIMS),
        "grid_from_numpy": lambda: grid_from_numpy(ref.iso.host_values, ref.iso.knots, ref.iso.columns),
        "grid_from_reference": lambda: grid_from_reference(ref.iso),
    }
    with pytest.raises((RuntimeError, AssertionError)):  # torch's own refusal, by build
        calls[entry]()


def test_get_ichrone_default_is_mist_and_names_unknown_grids(tmp_path, monkeypatch):
    """The reference's default and order of checks: an instance first, then
    the names; the MIST grids without their files under an empty
    ``$ISOCHRONES`` raise an error that names the missing path."""
    import inspect

    import isochrones_torch.config as tconfig
    from isochrones_tpu import get_ichrone as jax_get_ichrone
    from isochrones_torch import get_ichrone
    from isochrones_torch.grids.base import MissingGridError

    ref = list(inspect.signature(jax_get_ichrone).parameters)[:4]
    assert list(inspect.signature(get_ichrone).parameters)[:4] == ref == ["models", "bands", "tracks", "basic"]
    assert inspect.signature(get_ichrone).parameters["models"].default == "mist"
    monkeypatch.setattr(tconfig, "ISOCHRONES", str(tmp_path))
    with pytest.raises(MissingGridError, match=re.escape(os.path.join(str(tmp_path), "BC", "mist"))):
        get_ichrone(device="cpu")
    with pytest.raises(MissingGridError, match=re.escape(os.path.join(str(tmp_path), "BC", "mist"))):
        get_ichrone("mist", basic=True, device="cpu")
    with pytest.raises(ValueError, match="Unknown model grid"):
        get_ichrone("parsec", device="cpu")


def test_get_ichrone_pair_cache_and_pass_through(bundles):
    """``tracks=True`` gives the evolution-track interpolator, cross-linked
    with the isochrone one; two calls share one set of tables; an
    interpolator instance comes back as it is; the EEP support arrays are the
    JAX package's."""
    from isochrones_tpu import get_ichrone as jax_get_ichrone
    from isochrones_torch import get_ichrone
    from isochrones_torch.models import EvolutionTrackInterpolator, IsochroneInterpolator

    iso = get_ichrone("synthetic", device="cpu", **_DIMS)
    track = get_ichrone("synthetic", tracks=True, device="cpu", **_DIMS)
    assert type(iso) is IsochroneInterpolator and type(track) is EvolutionTrackInterpolator
    assert iso.track is track and track.iso is iso
    assert get_ichrone("synthetic", device="cpu", **_DIMS) is iso
    assert get_ichrone("synthetic", device=torch.device("cpu"), **_DIMS).model.values is iso.model.values
    assert get_ichrone(iso) is iso and get_ichrone(track, tracks=False, device="cuda") is track
    # another dtype, another band list or another size is another grid
    iso32 = get_ichrone("synthetic", device="cpu", dtype=torch.float32, **_DIMS)
    assert iso32 is not iso and iso32.dtype == torch.float32 and iso32.track.eep_support[2].dtype == torch.float32
    jk = get_ichrone("synthetic", bands=["J", "K"], device="cpu", **_DIMS)
    assert jk is not iso and jk.bands == ["J", "K"] and jk.bc.columns == ("J", "K")
    assert get_ichrone("synthetic", bands=("J", "K"), device="cpu", **_DIMS) is jk

    jtrack = jax_get_ichrone("synthetic", tracks=True, **_DIMS)
    assert (track.param_names, track.eep_replaces, track._param_index_order, track.name) == (
        jtrack.param_names, jtrack.eep_replaces, jtrack._param_index_order, jtrack.name)
    assert track._param_index_order == (2, 0, 1, 3, 4) and track.eep_replaces == "age"
    _same_grid(track.model, bundles[0].track)
    for a, b in zip(track.eep_support, jtrack.eep_support):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert iso.eep_support is None
    assert [track.get_limits(p) for p in ("mass", "feh", "eep", "age")] == \
        [jtrack.get_limits(p) for p in ("mass", "feh", "eep", "age")]
    pars = [1.0, 45.0, -0.2, 300.0, 0.1]
    for a, b in zip(track.interp_mag(pars, ["J", "K"]), jtrack.interp_mag(pars, ["J", "K"])):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    # a track interpolator without its isochrone twin, and the reverse
    lone = IsochroneInterpolator(iso.model, iso.bc)
    with pytest.raises(ValueError, match="no linked track interpolator"):
        lone.track
    assert EvolutionTrackInterpolator(track.model, track.bc).iso is None
    with pytest.raises(ValueError, match="No EEP support"):
        EvolutionTrackInterpolator(track.model, track.bc).get_eep(1.0, 9.0, 0.0)


def test_utils_match_reference():
    import isochrones_tpu.utils as ju
    import isochrones_torch.utils as tu

    assert (tu.G_CGS, tu.MSUN_CGS, tu.RSUN_CGS) == (ju.G_CGS, ju.MSUN_CGS, ju.RSUN_CGS)
    a = np.array([10.0, 12.5, 9.0])
    b = np.array([11.0, np.inf, 9.0])  # +inf: no secondary
    np.testing.assert_array_equal(tu.addmags(a, b), ju.addmags(a, b))
    np.testing.assert_array_equal(tu.addmags((10.0, 0.02), (11.0, 0.05)), ju.addmags((10.0, 0.02), (11.0, 0.05)))
