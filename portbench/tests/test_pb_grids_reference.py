"""The frozen tables and the reference against the program's plain CPU paths
at small sizes. Only these tests import the program."""

import numpy as np
import pytest
import torch

from portbench import grids
from portbench.drivers import catalog_fit, cluster_posterior, common
from portbench.reference import cluster as ref_cluster
from portbench.reference.catalog import Posterior, quantiles
from portbench.reference.interp import interp

CPU = torch.device("cpu")
SIZES = dict(n_feh=5, n_mass=20, n_eep=80, n_age=12)


def test_tables_match_the_program_builder():
    from isochrones_torch.grids.synthetic import make_synthetic_grids

    want = make_synthetic_grids(**SIZES, bands=("J", "H", "K"), device="cpu", dtype=torch.float64)
    values, knots = grids.iso_table(**SIZES, device=CPU)
    assert want.iso.columns[:-1] == grids.ISO_COLUMNS[:-1] and want.iso.columns[-1] == "dm_deep"
    for k, w in zip(knots, want.iso.knots):
        np.testing.assert_array_equal(k, w.numpy())
    w = want.iso.values.numpy()
    np.testing.assert_array_equal(np.isnan(values.numpy()), np.isnan(w))
    np.testing.assert_allclose(values.numpy(), w, rtol=1e-13, atol=0)
    bc, bc_knots = grids.bc_table(("J", "H", "K"), CPU)
    np.testing.assert_allclose(bc.numpy(), want.bc.values.numpy(), rtol=1e-13, atol=1e-15)
    for k, w in zip(bc_knots, want.bc.knots):
        np.testing.assert_array_equal(k, w.numpy())


def test_interp_matches_the_program_on_edges():
    from isochrones_torch.ops.interp import compute_axis_maps, interp_nd_plain

    values, knots = grids.iso_table(**SIZES, device=CPU)
    kt = tuple(torch.as_tensor(k) for k in knots)
    rng = np.random.default_rng(3)
    n = 4000
    pts = np.stack([rng.uniform(k[0] - 0.1, k[-1] + 0.1, n) for k in knots], -1)
    for d, k in enumerate(knots):  # exact knots, top knots, NaN
        pts[d::7, d] = k[rng.integers(0, len(k), len(pts[d::7]))]
        pts[3 + d::11, d] = k[-1]
    pts[5::13, 1] = np.nan
    p = torch.as_tensor(pts)
    cols = [3, 4, 14]
    got = interp(values, kt, p, cols)
    want = interp_nd_plain(values, kt, p, icols=tuple(cols), axis_maps=compute_axis_maps(knots))
    np.testing.assert_array_equal(torch.isnan(got).numpy(), torch.isnan(want).numpy())
    ok = ~torch.isnan(want)
    np.testing.assert_allclose(got[ok].numpy(), want[ok].numpy(), rtol=1e-12, atol=1e-12)


def test_cluster_posterior_matches_the_program(tiny_cell):
    _, _, cfg, traffic = tiny_cell("cluster50.evals1024")
    state = cluster_posterior.setup(cfg, traffic, 7, CPU)
    p = torch.cat([state.pool[0], state.pool[1] * torch.tensor([1, 1, 1, 1, 1, 1, 3.0])])  # some fB outside its prior
    prog = state.model.lnpost_batch(p).numpy()
    want = ref_cluster.lnpost(p, state.tables, state.stars, cfg).numpy()
    gap, mismatch = common.gaps(prog, want)
    assert mismatch == 0 and gap < 1e-11
    assert np.isfinite(want).sum() >= 8 and (~np.isfinite(want)).sum() >= 1


def test_catalog_posterior_matches_the_program(tiny_cell):
    from isochrones_torch.batch import BatchStarFitter

    _, _, cfg, traffic = tiny_cell("catalog4096.nested")
    ic, tables = common.interpolator(cfg, CPU)
    truths, cols, obs = catalog_fit.catalogue(cfg, tables, CPU)
    S = len(truths)
    rng = np.random.default_rng(0)
    x = truths[:, None, :] + rng.normal(0, 1, (S, 40, 5)) * np.array([15.0, 0.1, 0.1, 20.0, 0.05])
    x[:, 0, 0] = np.nan
    x[:, 1, 3] = -5.0
    prog = BatchStarFitter(ic, cols).lnpost_batch(x).numpy()
    want = Posterior(tables, obs, cfg)(torch.as_tensor(x), torch.arange(S)).numpy()
    gap, mismatch = common.gaps(prog, want)
    assert mismatch == 0 and gap < 1e-11
    assert np.isfinite(want).mean() > 0.3


@pytest.mark.parametrize("with_nan", [False, True])
def test_quantiles_are_numpy_nanquantile(with_nan):
    rng = np.random.default_rng(1)
    d = rng.normal(size=(7, 333))
    if with_nan:
        d[2] = np.nan
        d[4, ::3] = np.nan
    got = quantiles(d, (0.16, 0.5, 0.84))
    with np.errstate(invalid="ignore"):
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            want = np.nanquantile(d, (0.16, 0.5, 0.84), axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-15)
