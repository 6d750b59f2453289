"""The CUDA kernels on the card against their plain PyTorch versions.

Marked ``cuda``: every test skips without a CUDA card. This file imports no
JAX, so it also runs on a machine without it, from the repository root:

    python -m pytest --noconftest -o filterwarnings=error -m cuda tests/test_torch_cuda.py

Tolerances are those of ``chip_smoke.py``. Cluster kernel: rtol 1e-10 in
float64 (another summation order); float32 against the float64 plain version
on the same float32 inputs within 1e-3 + 1e-4 |ref| (float32 rounding of
sums over ~1e3-1e6 cells, ex2.approx exponentials); the finite pattern must
be identical and the kernel never returns NaN. Star kernel: rtol 1e-10 in
float64 and 0.05 + 1e-4 |ref| for float32 against the float64 plain version
on the same float32 tables and points, with identical NaN and +-inf
patterns, for N = 1, 2, 3, every axis-map kind and every group width, on
adversarial points. Tree kernel (``ll`` and the EEP prior's two columns per
star): 1e-9 + 1e-10 |ref| in float64; in float32 against the float64 plain
version 0.1 + 2e-4 |ref| for ``ll`` and 1e-6 + 1e-4 |ref| for the columns;
identical NaN and -inf patterns and ``ll`` never NaN, for 1-16 stars, one and
two systems, relative rows, density rows, limits, every axis-map kind, every
group width, batches that leave a partial team and a partial warp. Catalog
kernel, both instantiations (the likelihood's triple and the posterior): the
star kernel's tolerances, for 1-256 stars, every group width (by the launch
table and forced), every axis-map kind, stars without a band, without any
band, without a parallax or Teff, a catalog without parallaxes, the
unit-cube form, replaced priors (the composition route); float32 against the
float64 plain version on the same float32 tables, points and constants
(``catalog_priors_as``); one fitter ``lnpost_batch`` is one launch.
Forward-model kernel (kernel F, every form: the inversion, the EEP given,
the EEP alone, ``all_As``): float64 EEPs bitwise and the columns and
magnitudes to rtol 1e-10 of their scale; float32 against the float64 plain
version on the same float32 tables and inputs, EEPs to 2e-3 and the columns
at the kernel's own EEPs to rtol 2e-5 of their scale (``check_generate``);
every axis-map kind, 1, 3 and 16 bands (the compact table's widths), no
columns and every column, batches that leave a partial warp; the caps raise
by name; the interpolators' ``generate`` and fast ``get_eep`` launch it.
The joint isochrone + track model: the star kernel on a track grid (its
index order, mass axis and parallax) at the star kernel's tolerances, and
``IsoTrackModel.lnpost_batch`` (two launches, also with a prior of a
subclass's own or another EEP prior) against the CPU at rtol 1e-10; a grid
without the 6-column pack raises; a track-grid results file reloads onto
the track grid on the card. Kernel B (``interp_nd``) against the plain
version on the same card tensors: float64 within 1e-9 of the value plus
1e-13 of the column's scale, float32 within 2e-6 of the column's scale
(``chip_smoke.check_interp``: the same products, summed in another order),
identical NaN patterns, every axis kind, 1-6 axes, column subsets; B'
against autograd of the plain version, 1e-9 of the row's scale in float64;
the wrapper's refusals (mixed dtypes, the caps); a seismic binary's
posterior and gradient against the CPU.
"""

import copy
import dataclasses
import re
import warnings

import numpy as np
import pytest
import torch

from chip_smoke import (
    check_generate, check_newton, generate_points, plain_accurate, plain_newton, wrapper_launches,
    CAT_BANDS, CLI_EEP_BOX, catalog_likelihood_as, catalog_points, catalog_priors_as, catalog_table,
    ATOL_F32, ATOL_STAR_F32, FIXTURE, RTOL_F32, RTOL_F64, RTOL_STAR_F32, RTOL_STAR_F64, _tree_check, as_float32,
    _tree_mixed_points, check_close, check_eep, check_star, eep_points, grid_as, isotrack_observations,
    isotrack_points, isotrack_reference, make_kernel_inputs, profile_kernels, star_grid_variant, star_observations,
    star_points, to_torch,
)
from isochrones_torch import BinaryStarModel, StarClusterModel, TripleStarModel, get_ichrone
from isochrones_torch.batch import BatchStarFitter
from isochrones_torch.catalog import read_csv
from isochrones_torch.ops.catalog import catalog_lnlike, catalog_lnlike_plain, catalog_lnpost_plain, unit_box
from isochrones_torch.ops.catalog_cuda import catalog_lnlike_cuda, catalog_lnpost_cuda, compact_bc
from isochrones_torch.ops.cluster import cluster_lnmarginal, cluster_lnmarginal_plain
from isochrones_torch.ops.cluster_cuda import cluster_lnmarginal_cuda
from isochrones_torch.ops.star import star_lnlike_fused, star_lnlike_fused_plain
from isochrones_torch.ops.star_cuda import star_lnlike_cuda
from isochrones_torch.ops.tree import tree_lnlike, tree_lnlike_fused, tree_lnlike_fused_plain
from isochrones_torch.ops.tree_cuda import MAX_STARS, launch_geometry, tree_lnlike_cuda
from isochrones_torch.priors import GaussianPrior, SalpeterPrior
from isochrones_torch.treemodel import StarModel

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


#: cluster shapes (S, E, B, W): star counts off the star tiles (10 stars at 3
#: bands in float32, 5 in float64), ladders below one warp and off the
#: 16-row tile, every band count with its own instantiation (1-4) and the
#: generic one (6, 16)
_CLUSTER_SHAPES = [(7, 50, 4, 3), (9, 33, 1, 2), (17, 130, 6, 4), (3, 1, 2, 1), (13, 21, 3, 2), (11, 45, 16, 2),
                   (23, 70, 2, 3)]


@pytest.mark.parametrize("S,E,B,W", _CLUSTER_SHAPES)
@pytest.mark.parametrize("q_jacobian", [False, True])
def test_kernel_matches_plain_f64(dev, S, E, B, W, q_jacobian):
    a, kw = to_torch(make_kernel_inputs(S, E, B, W, seed=S * E), dev, torch.float64)
    ref = cluster_lnmarginal_plain(*a, q_jacobian=q_jacobian, **kw).cpu().numpy()
    got = cluster_lnmarginal_cuda(*a, q_jacobian=q_jacobian, **kw)
    torch.cuda.synchronize()
    check_close("f64", got.cpu().numpy(), ref, RTOL_F64)


@pytest.mark.parametrize("S,E,B,W,q_jacobian", [(11, 90, 3, 4, False), (13, 21, 1, 2, True), (12, 64, 16, 2, False),
                                                (50, 1710, 3, 2, False)])
def test_kernel_matches_plain_f32(dev, S, E, B, W, q_jacobian):
    inputs = as_float32(make_kernel_inputs(S, E, B, W, seed=5))
    a32, kw32 = to_torch(inputs, dev, torch.float32)
    a64, kw64 = to_torch(inputs, dev, torch.float64)
    got = cluster_lnmarginal_cuda(*a32, q_jacobian=q_jacobian, **kw32).cpu().numpy()
    ref = cluster_lnmarginal_plain(*a64, q_jacobian=q_jacobian, **kw64).cpu().numpy()
    check_close("f32", got, ref, RTOL_F32, ATOL_F32)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_nan_observed_magnitude(dev, dtype):
    """A NaN observed magnitude: the plain version gives that star NaN, the
    kernel -inf (the Pallas kernel's NaN route); the other stars agree."""
    inputs = make_kernel_inputs(9, 60, 3, 2, seed=3)
    inputs["mag_values"][4, 1] = np.nan
    a, kw = to_torch(inputs, dev, dtype)
    got = cluster_lnmarginal_cuda(*a, **kw).cpu().numpy()
    ref = cluster_lnmarginal_plain(*to_torch(inputs, dev, torch.float64)[0], **to_torch(inputs, dev, torch.float64)[1])
    ref = ref.cpu().numpy()
    assert np.isnan(ref[:, 4]).all() and (got[:, 4] == -np.inf).all()
    if dtype == torch.float64:
        check_close("nan star f64", got, ref, RTOL_F64)
    else:
        check_close("nan star f32", got, ref, RTOL_F32, ATOL_F32)


def test_dispatch_launches_kernel_on_cuda(dev):
    a, kw = to_torch(make_kernel_inputs(5, 40, 3, 2, seed=1), dev, torch.float64)
    before = cluster_lnmarginal_cuda.launches
    out = cluster_lnmarginal(*a, **kw)
    assert out.is_cuda and cluster_lnmarginal_cuda.launches == before + 1


def test_kernel_rejects_bad_input(dev):
    a, kw = to_torch(make_kernel_inputs(5, 40, 3, 2, seed=1), dev, torch.float64)
    bad = list(a)
    bad[1] = bad[1].float()  # model_mags in another dtype
    with pytest.raises(TypeError):
        cluster_lnmarginal_cuda(*bad, **kw)
    bad = list(a)
    bad[4] = bad[4][:-1]  # eeps of the wrong length
    with pytest.raises(ValueError):
        cluster_lnmarginal_cuda(*bad, **kw)


def test_cluster_model_on_card_matches_cpu(dev):
    """The slice on a small grid: lnpost through the kernel on the card
    against the plain path on the CPU, float64, rtol 1e-9."""
    data = read_csv(FIXTURE)
    kw = dict(bands=("J", "H", "K"), props=("parallax",), eep_bounds=(1, 1400), eep_step=20.0,
              max_distance=3000, minq=0.2, mass_bounds=(0.6, 2.0))
    grid = dict(n_feh=5, n_mass=40, n_eep=1710, n_age=20)
    gpu = StarClusterModel(get_ichrone("synthetic", device=dev, **grid), data, **kw)
    cpu = StarClusterModel(get_ichrone("synthetic", device="cpu", **grid), data, **kw)
    rng = np.random.default_rng(0)
    truth = np.array([9.0, 0.0, 300.0, 0.05, -2.0, 0.3, 0.3])
    p = truth + rng.normal(0, [0.05, 0.05, 5.0, 0.01, 0.1, 0.03, 0.03], size=(12, 7))
    check_close("slice", gpu.lnpost_batch(p).cpu().numpy(), cpu.lnpost_batch(p).numpy(), 1e-9)


@pytest.mark.parametrize("accurate", [False, True], ids=["fast", "accurate"])
def test_get_eep_on_card_matches_cpu(dev, accurate):
    """The EEP inversion through kernel F on the card gives what the plain
    version gives on the CPU (float64, 1e-9, identical NaN pattern), on both
    interpolators."""
    gpu, cpu = (get_ichrone("synthetic", device=d, tracks=True, **_SMALL) for d in (dev, "cpu"))
    mass, age, feh = eep_points(cpu, 3000, seed=4)
    check_eep("track", gpu.get_eep(mass, age, feh, accurate=accurate), cpu.get_eep(mass, age, feh, accurate=accurate))
    if accurate:
        n = check_eep("iso", gpu.iso.get_eep(mass, age, feh, accurate=True),
                      cpu.iso.get_eep(mass, age, feh, accurate=True))[1]
        assert n > 300


def test_simulated_cluster_on_card_matches_cpu(dev):
    from isochrones_torch import SimulatedCluster

    kw = dict(age=9.0, feh=0.0, distance=300.0, AV=0.05, alpha=-2.0, gamma=0.3, fB=0.3, bands=("J", "K"), rng=5)
    gpu = SimulatedCluster(40, device=dev, **kw, **_SMALL)
    cpu = SimulatedCluster(40, device="cpu", **kw, **_SMALL)
    assert gpu.ic.device.type == "cuda" and list(gpu.data) == list(cpu.data)
    for c in cpu.data:
        check_eep(c, gpu.data[c], cpu.data[c])


def test_nested_cluster_fit_on_card(dev, monkeypatch):
    """A short nested cluster fit through the kernel: dynamic by default at
    the card's batch (n_batch clamped to n_live // 4), a walker batch past
    the byte budget cut into several launches with the same result."""
    import isochrones_torch.cluster as cluster_mod
    from isochrones_torch import SimulatedCluster

    ic = get_ichrone("synthetic", device=dev, dtype=torch.float32, **_SMALL)
    sim = SimulatedCluster(8, age=9.0, feh=0.0, distance=300.0, AV=0.05, alpha=-2.0, gamma=0.3, fB=0.3,
                           bands=("J", "K"), mass_range=(0.6, 2.0), phot_unc=0.05, rng=0, ic=ic)
    kw = dict(eep_bounds=(1, 81), eep_step=2.0, max_distance=2000)
    model = StarClusterModel(ic, sim, **kw)
    before = cluster_lnmarginal_cuda.launches
    res = model.fit(n_live_points=64, seed=0)
    assert cluster_lnmarginal_cuda.launches > before
    assert np.isfinite(res.logz) and model.evidence == (res.logz, res.logzerr) and len(model.samples["age"]) == 4000
    pts = model.sample_from_prior(37, values=True, rng=1)
    whole = model.lnlike_batch(pts).cpu().numpy()
    per_walker = cluster_mod._walker_bytes(8, model._n_ladder, 2, 4)
    monkeypatch.setattr(cluster_mod, "_WALKER_BYTES_BUDGET", 5 * per_walker)
    before = cluster_lnmarginal_cuda.launches
    pieces = StarClusterModel(ic, sim, **kw).lnlike_batch(pts).cpu().numpy()
    assert cluster_lnmarginal_cuda.launches == before + 8
    np.testing.assert_allclose(pieces, whole, rtol=1e-6)


_SMALL = dict(n_feh=7, n_mass=30, n_eep=100, n_age=30)
#: a binary inside the small grid: EEPs 60 and 40, age, feh, distance, AV
_SMALL_TRUTH = (60.0, 40.0, 9.0, 0.0, 200.0, 0.1)


def _likelihood(dev, dtype, N, kind, drop=()):
    """A fused-likelihood description on the small grid with the axes of
    ``kind`` and the bench's observations less ``drop``."""
    from isochrones_torch import SingleStarModel

    ic = get_ichrone("synthetic", device=dev, dtype=dtype, **_SMALL)
    obs = {k: v for k, v in star_observations(get_ichrone("synthetic", device="cpu", **_SMALL), _SMALL_TRUTH).items() if k not in drop}
    if "logg" in drop:
        obs["logg"] = (float("nan"), 0.1)  # a missing channel
    model = {1: SingleStarModel, 2: BinaryStarModel, 3: TripleStarModel}[N](ic, **obs)
    lk = model._star_likelihood()
    pack6, bc = star_grid_variant(lk.pack6, lk.bc, kind)
    return dataclasses.replace(lk, pack6=pack6, bc=bc)


def _check_star_both(lk64, pts, name):
    """The kernel against the plain version on ``pts``: float64 at rtol
    1e-10, float32 tables and points against the float64 plain version on
    the same float32 values."""
    p64 = torch.as_tensor(pts, device=lk64.pack6.values.device, dtype=torch.float64)
    check_star(f"f64 {name}", [x.cpu().numpy() for x in star_lnlike_cuda(p64, lk64)],
               [x.cpu().numpy() for x in star_lnlike_fused_plain(p64, lk64)], RTOL_STAR_F64)
    lk32 = dataclasses.replace(lk64, pack6=grid_as(lk64.pack6, torch.float32), bc=grid_as(lk64.bc, torch.float32))
    lk32up = dataclasses.replace(lk64, pack6=grid_as(lk32.pack6, torch.float64), bc=grid_as(lk32.bc, torch.float64))
    p32 = p64.float()
    check_star(f"f32 {name}", [x.cpu().numpy() for x in star_lnlike_cuda(p32, lk32)],
               [x.cpu().numpy() for x in star_lnlike_fused_plain(p32.double(), lk32up)], RTOL_STAR_F32, ATOL_STAR_F32)


@pytest.mark.parametrize("B", [1, 31, 1024, 4096, 4097])
@pytest.mark.parametrize("kind", ["default", "log", "compare", "searchsorted"])
@pytest.mark.parametrize("N", [1, 2, 3])
def test_star_kernel_matches_plain(dev, N, kind, B):
    """Adversarial points, in batches that leave idle lanes in the last warp
    and take 16 or 8 lanes per (point, component)."""
    lk = _likelihood(dev, torch.float64, N, kind)
    pts = star_points(lk.pack6.knots, N, B, seed=N if B == 4096 else B + N)
    _check_star_both(lk, pts, f"N={N} {kind} B={B}")
    if B >= 4096:
        ref = star_lnlike_fused_plain(torch.as_tensor(pts, device=dev, dtype=torch.float64), lk)[0].cpu().numpy()
        assert np.isfinite(ref).sum() > 100 and np.isnan(ref).sum() > 100


@pytest.mark.parametrize("kind", ["default", "log", "compare", "searchsorted"])
@pytest.mark.parametrize("N", [1, 2, 3])
def test_star_kernel_exact_and_top_knots(dev, N, kind):
    """Every coordinate on a knot of the model grid, the top knot included
    (t = 0, _pin_top, the searchsorted equality branch)."""
    lk = _likelihood(dev, torch.float64, N, kind)
    ages, fehs, eeps = (k.cpu().numpy() for k in lk.pack6.knots)
    rng = np.random.default_rng(N)
    B = 777
    pts = np.stack([rng.choice(eeps, B) for _ in range(N)] + [rng.choice(ages, B), rng.choice(fehs, B),
                                                             rng.uniform(10, 3000, B), rng.uniform(0, 1.5, B)], -1)
    pts[::5, :N] = eeps[-1]
    pts[1::5, N] = ages[-1]
    pts[2::5, N + 1] = fehs[-1]
    _check_star_both(lk, pts, f"knots N={N} {kind}")


def _group_widths(fn, kernel):
    """The group widths G of the ``kernel`` kernels that ``fn`` launched, read
    from the template arguments of the kernel names in the profiler's trace.
    A window whose trace holds other device events but none of ``kernel``
    (the profiler drops a launch's event now and then) is run again, four
    windows at most."""
    pat = re.compile(kernel + r"<\w+, ?(\d+)>|" + kernel + r"I[fd]Li(\d+)E")
    for _ in range(4):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the profiler's own notices
            names = profile_kernels(fn)[1]
        widths = {int(m.group(1) or m.group(2)) for m in map(pat.search, names) if m}
        if widths:
            break
    return widths


@pytest.mark.parametrize("B,lanes", [(40000, 4), (70000, 2), (140000, 1)])
def test_star_kernel_group_widths(dev, B, lanes):
    """The narrow groups that large batches take, down to one lane per
    (point, component)."""
    lk = _likelihood(dev, torch.float64, 1, "default")
    pts = star_points(lk.pack6.knots, 1, B, seed=lanes)
    p = torch.as_tensor(pts, device=dev, dtype=torch.float64)
    assert _group_widths(lambda: star_lnlike_cuda(p, lk), "star_lnlike_kernel") == {lanes}
    _check_star_both(lk, pts, f"B={B}")


@pytest.mark.parametrize("drop", [("logg",), ("J", "H", "K", "G"), ("parallax",)],
                         ids=["missing_logg", "zero_bands", "no_parallax"])
def test_star_kernel_observation_variants(dev, drop):
    lk = _likelihood(dev, torch.float64, 2, "default", drop)
    p = torch.as_tensor(star_points(lk.pack6.knots, 2, 2048, seed=7), device=dev, dtype=torch.float64)
    check_star(str(drop), [x.cpu().numpy() for x in star_lnlike_cuda(p, lk)],
               [x.cpu().numpy() for x in star_lnlike_fused_plain(p, lk)], RTOL_STAR_F64)


def test_star_dispatch_and_model_on_card(dev):
    """The binary model's lnpost_batch through the kernel on the card against
    the plain path on the CPU, float64, rtol 1e-10; the dispatcher launches
    the kernel once per call."""
    lk = _likelihood(dev, torch.float64, 2, "default")
    p = torch.as_tensor(star_points(lk.pack6.knots, 2, 64, seed=1), device=dev, dtype=torch.float64)
    before = star_lnlike_cuda.launches
    star_lnlike_fused(p, lk)
    assert star_lnlike_cuda.launches == before + 1

    obs = star_observations(get_ichrone("synthetic", device="cpu", **_SMALL), _SMALL_TRUTH)
    gpu = BinaryStarModel(get_ichrone("synthetic", device=dev, **_SMALL), **obs)
    cpu = BinaryStarModel(get_ichrone("synthetic", device="cpu", **_SMALL), **obs)
    los, his = cpu._bounds_arrays()
    pts = los + (his - los) * np.random.default_rng(0).random((256, 6))
    pts[:, 2] = np.random.default_rng(1).uniform(8.5, 9.5, 256)
    check_star("binary lnpost", [gpu.lnpost_batch(pts).cpu().numpy()], [cpu.lnpost_batch(pts).numpy()], RTOL_STAR_F64)


def test_star_kernel_rejects_bad_input(dev):
    lk = _likelihood(dev, torch.float64, 2, "default")
    p = torch.as_tensor(star_points(lk.pack6.knots, 2, 16, seed=1), device=dev, dtype=torch.float64)
    with pytest.raises(ValueError):
        star_lnlike_cuda(p.float(), lk)  # tables in another dtype
    with pytest.raises(ValueError):
        star_lnlike_cuda(p[:, :5], lk)  # wrong parameter count
    bad = dataclasses.replace(lk, pack6=dataclasses.replace(lk.pack6, axis_maps=(("cubic", 0.0, 1.0),) * 3))
    with pytest.raises(ValueError):
        star_lnlike_cuda(p, bad)


_TREE_PHOT = dict(J=(9.5, 0.02), H=(9.2, 0.02), K=(9.1, 0.02))


def _tree_model(dev, case):
    """A tree model on the small grid, float64: ``single``/``N<k>`` (k stars
    of one system under blended photometry), ``star3`` (relative rows),
    ``two_systems`` (tests/star4 with index [0, 0, 1]), ``density`` (a
    density and an AV observation, a logg limit with an open end)."""
    ic = get_ichrone("synthetic", device=dev, **_SMALL)
    if case == "star3":
        return StarModel.from_ini(ic, "tests/star3")
    if case == "two_systems":
        return StarModel.from_ini(ic, "tests/star4", index=[0, 0, 1])
    if case == "density":
        mod = StarModel(ic, N=2, Teff=(5800, 100), density=(1.4, 0.3), AV=(0.1, 0.05), parallax=(5.0, 0.05),
                        **_TREE_PHOT)
        mod.obs.add_limit(logg=(3.5, None))
        mod.obs.add_limit(label="0_1", density=(None, 50.0))
        return mod
    n = 1 if case == "single" else int(case[1:])
    return StarModel(ic, N=n, Teff=(5800, 100), logg=(4.4, 0.1), parallax=(5.0, 0.05), **_TREE_PHOT)


def _tree_pts(mod, B, seed):
    return _tree_mixed_points(mod.param_names, mod.ic.model.knots, B, seed=seed)


@pytest.mark.parametrize("B", [1, 31, 1024, 4097])
@pytest.mark.parametrize("case", ["single", "N2", "N3", "N4", "N5", "N6", "N7", "N8", "N11", "N16", "star3",
                                  "two_systems", "density"])
def test_tree_kernel_matches_plain(dev, case, B):
    """Adversarial points (knots, top knots, one star off the grid, NaN), in
    batches that leave idle teams in the last warp, for star counts on and
    off the powers of two up to the cap."""
    mod = _tree_model(dev, case)
    lk = mod._get_fn("lnlike").likelihood
    _, _, fin, n = _tree_check(f"{case} B={B}", lk, _tree_pts(mod, B, seed=B), dev)
    if B >= 1024:
        assert n // 16 < fin < n - n // 16, (fin, n)


#: (case, B, star groups, lanes a group): every team shape the launch
#: geometry can choose, at batches that leave a partial team and warp
_TREE_GEOMETRIES = [
    ("single", 1024, 1, 16), ("single", 20001, 1, 8), ("single", 40001, 1, 4), ("single", 70001, 1, 2),
    ("single", 140001, 1, 1), ("N2", 1023, 2, 16), ("N2", 9001, 2, 8), ("N2", 140001, 2, 1), ("N3", 1024, 4, 8),
    ("N3", 12289, 4, 4), ("N3", 24577, 4, 2), ("N3", 50001, 4, 1), ("N3", 70001, 1, 1), ("N5", 1025, 8, 4),
    ("N5", 12001, 8, 2), ("N5", 30001, 8, 1), ("N5", 40001, 1, 1), ("N6", 50001, 2, 1), ("N7", 40001, 1, 1),
    ("N11", 20001, 1, 1), ("N12", 20001, 4, 1), ("N16", 1021, 16, 2), ("N16", 20001, 16, 1), ("star3", 12289, 4, 4),
    ("two_systems", 24577, 4, 2), ("two_systems", 70001, 1, 1), ("density", 9001, 2, 8),
]


@pytest.mark.parametrize("case,B,groups,lanes", _TREE_GEOMETRIES)
def test_tree_kernel_launch_geometry(dev, case, B, groups, lanes):
    """Every team shape the launch geometry can choose (star groups side by
    side or taking their stars in turn, every group width), at batches that
    leave a partial team and a partial warp."""
    mod = _tree_model(dev, case)
    lk = mod._get_fn("lnlike").likelihood
    pts = _tree_pts(mod, B, seed=lanes)
    p = torch.as_tensor(pts, device=dev, dtype=torch.float64)
    assert launch_geometry(B, lk.n_stars) == (groups, lanes)
    assert _group_widths(lambda: tree_lnlike_cuda(p, lk), "tree_lnlike_kernel") == {lanes}
    _tree_check(f"{case} B={B}", lk, pts, dev)


@pytest.mark.parametrize("kind", ["log", "compare", "searchsorted"])
@pytest.mark.parametrize("B", [2048, 40000])
def test_tree_kernel_axis_kinds(dev, kind, B):
    """The other kinds of cell location, through the shared interpolation
    code, with 8 lanes per star and with 1."""
    mod = _tree_model(dev, "star3")
    lk = mod._get_fn("lnlike").likelihood
    model, bc = star_grid_variant(lk.model, lk.bc, kind)
    lk = dataclasses.replace(lk, model=model, bc=bc)
    _tree_check(f"star3 {kind}", lk, _tree_pts(mod, B, seed=3), dev)


@pytest.mark.parametrize("B", [1, 1024, 40000])
def test_tree_kernel_off_grid_star_spoils_only_its_rows(dev, B):
    """A star below the grid that sits only in an inactive row leaves the
    likelihood finite; once its row is active the point is -inf. Its two
    prior columns are NaN, the other stars' are the plain version's."""
    mod = _tree_model(dev, "star3")
    lk = mod._get_fn("lnlike").likelihood
    rows_of_2 = lk.member[:, 2] > 0
    quiet = dataclasses.replace(lk, obs_active=torch.where(rows_of_2, 0, lk.obs_active).to(torch.int32))
    eeps = mod.ic.model.knots[2]
    p = torch.tensor([[60.0, 50.0, float(eeps[0]) - 0.5, 9.0, 0.0, 200.0, 0.1]], device=dev, dtype=torch.float64)
    p = p.repeat(B, 1)
    p[:, 0] += torch.linspace(0, 5, B, device=dev, dtype=torch.float64)
    for which, finite in ((quiet, True), (lk, False)):
        ll, orig_val, deriv = tree_lnlike_cuda(p, which)
        ref = tree_lnlike_fused_plain(p, which)
        if finite:
            assert torch.isfinite(ll).all() and torch.isfinite(ref[0]).all()
        else:
            assert (ll == float("-inf")).all() and (ref[0] == float("-inf")).all()
        assert torch.isnan(orig_val[:, 2]).all() and torch.isnan(deriv[:, 2]).all()
        assert torch.isfinite(orig_val[:, :2]).all() and torch.isfinite(deriv[:, :2]).all()
        check_star("off grid", [x.cpu().numpy() for x in (ll, orig_val, deriv)], [x.cpu().numpy() for x in ref], 1e-10)
    _tree_check("off grid", quiet, p.cpu().numpy(), dev)


@pytest.mark.parametrize("case,B", [("star3", 1024), ("star3", 50000), ("N16", 777), ("two_systems", 12289)])
def test_tree_kernel_two_launches_bitwise_equal(dev, case, B):
    """No atomics, a fixed order of every sum: a point's result does not
    depend on the launch, nor on the points beside it in the batch."""
    mod = _tree_model(dev, case)
    lk = mod._get_fn("lnlike").likelihood
    for dtype in (torch.float64, torch.float32):
        which = lk if dtype == torch.float64 else _as_dtype(lk, dtype)
        p = torch.as_tensor(_tree_pts(mod, B, seed=9), device=dev, dtype=dtype)
        first = [x.clone() for x in tree_lnlike_cuda(p, which)]
        second = tree_lnlike_cuda(p, which)
        flipped = [x.flip(0) for x in tree_lnlike_cuda(p.flip(0).contiguous(), which)]
        for a, b, c in zip(first, second, flipped):
            assert torch.equal(a.view(torch.int64 if dtype == torch.float64 else torch.int32),
                               b.view(torch.int64 if dtype == torch.float64 else torch.int32))
            assert torch.equal(torch.nan_to_num(a, nan=-1.0), torch.nan_to_num(c, nan=-1.0))


def _as_dtype(lk, dtype):
    from chip_smoke import tree_likelihood_as

    return tree_likelihood_as(lk, dtype)


def test_tree_dispatch_model_and_caps(dev):
    """The dispatchers launch the kernel once per call; the tree model's
    fused lnpost_batch on the card equals the CPU's (float64, rtol 1e-10),
    and its composed path on the card; a plan beyond a cap raises and names
    it; a table in another dtype raises."""
    mod = _tree_model(dev, "two_systems")
    lk = mod._get_fn("lnlike").likelihood
    pts = _tree_pts(mod, 256, seed=5)
    p = torch.as_tensor(pts, device=dev, dtype=torch.float64)
    before = tree_lnlike_cuda.launches
    tree_lnlike(p, lk)
    tree_lnlike_fused(p, lk)
    assert tree_lnlike_cuda.launches == before + 2
    assert mod._build_lnpost_fused() is not None
    before = tree_lnlike_cuda.launches
    got = mod.lnpost_batch(pts).cpu().numpy()
    assert tree_lnlike_cuda.launches == before + 1
    cpu = StarModel.from_ini(get_ichrone("synthetic", device="cpu", **_SMALL), "tests/star4", index=[0, 0, 1])
    check_star("tree lnpost", [got], [cpu.lnpost_batch(pts).numpy()], 1e-10, 1e-9)
    lnpr, ll = mod.lnprior_batch(pts), mod.lnlike_batch(pts)
    composed = torch.where(torch.isfinite(lnpr), lnpr + ll, float("-inf")).cpu().numpy()
    check_star("tree lnpost fused vs composed", [got], [composed], 1e-10, 1e-9)
    with pytest.raises(ValueError):
        tree_lnlike_cuda(p.float(), lk)
    with pytest.raises(ValueError):
        tree_lnlike_cuda(p[:, :5], lk)
    big = StarModel(mod.ic, N=MAX_STARS + 1, **_TREE_PHOT)
    pb = torch.zeros((4, big.n_params), device=dev, dtype=torch.float64)
    with pytest.raises(ValueError, match="MAX_STARS"):
        big.lnlike_batch(pb)


def _catalog(dev, n_stars, plax=True, seed=0):
    """A catalog likelihood on the small grid (float64, on ``dev``) with the
    holes of ``chip_smoke.catalog_table``, and the stars' truths."""
    ic = get_ichrone("synthetic", device="cpu", **_SMALL)
    truths, table = catalog_table(ic, max(n_stars, 12), (CLI_EEP_BOX[0] / 2, CLI_EEP_BOX[1] / 2), seed=seed)
    table = {k: v[:n_stars] for k, v in table.items()}
    if not plax:
        table = {k: v for k, v in table.items() if not k.startswith("parallax")}
    fitter = BatchStarFitter(get_ichrone("synthetic", device=dev, **_SMALL), table, bands=CAT_BANDS)
    return fitter, truths[:n_stars]


def _check_catalog_both(lk64, pars, name):
    """The catalog kernel against the plain version on ``pars`` (S, B, 5):
    float64 at rtol 1e-10, float32 tables, observations and points against
    the float64 plain version on the same float32 values."""
    p64 = torch.as_tensor(pars, device=lk64.spec_vals.device, dtype=torch.float64)
    check_star(f"f64 {name}", [x.cpu().numpy() for x in catalog_lnlike_cuda(p64, lk64)],
               [x.cpu().numpy() for x in catalog_lnlike_plain(p64, lk64)], RTOL_STAR_F64)
    lk32 = catalog_likelihood_as(lk64, torch.float32)
    p32 = p64.float()
    check_star(f"f32 {name}", [x.cpu().numpy() for x in catalog_lnlike_cuda(p32, lk32)],
               [x.cpu().numpy() for x in catalog_lnlike_plain(p32.double(), catalog_likelihood_as(lk32, torch.float64))],
               RTOL_STAR_F32, ATOL_STAR_F32)


@pytest.mark.parametrize("S,B", [(1, 1), (3, 31), (12, 64), (16, 200), (64, 400), (256, 256), (16, 8000),
                                 (64, 4097)])
def test_catalog_kernel_matches_plain(dev, S, B):
    """Batches inside one warp, one block and many, with a ragged last warp;
    stars without H, without a parallax, without Teff (star 7) and without
    any band (star 11); NaN, top-knot and off-grid points."""
    fitter, truths = _catalog(dev, S)
    lk = fitter._catalog_likelihood()
    pars = catalog_points(fitter.ic, truths, max(B, 8), seed=S + B)[:, :B]
    if B < 8:
        pars[:, -1, 2] = np.nan
    _check_catalog_both(lk, pars, f"S={S} B={B}")
    if S * B >= 4096:
        ref = catalog_lnlike_plain(torch.as_tensor(pars, device=dev), lk)[0].cpu().numpy()
        assert np.isfinite(ref).sum() > 100 and np.isnan(ref).sum() > 10


@pytest.mark.parametrize("kind", ["log", "compare", "searchsorted"])
def test_catalog_kernel_axis_kinds(dev, kind):
    fitter, truths = _catalog(dev, 12)
    lk = fitter._catalog_likelihood()
    pack6, bc = star_grid_variant(lk.pack6, lk.bc, kind)
    _check_catalog_both(dataclasses.replace(lk, pack6=pack6, bc=bc), catalog_points(fitter.ic, truths, 300, seed=3),
                        kind)


def test_catalog_kernel_without_parallaxes(dev):
    fitter, truths = _catalog(dev, 12, plax=False)
    lk = fitter._catalog_likelihood()
    assert lk.plax is None
    _check_catalog_both(lk, catalog_points(fitter.ic, truths, 200, seed=4), "no parallax")


def test_catalog_kernel_caps_and_bad_input(dev):
    """Past 16 bands the kernel raises a ValueError that names the cap; it
    never falls back to the plain version."""
    fitter, truths = _catalog(dev, 4)
    lk = fitter._catalog_likelihood()
    p = torch.as_tensor(catalog_points(fitter.ic, truths, 16, seed=5), device=dev)
    S = lk.n_stars
    wide = dataclasses.replace(lk, band_icols=lk.band_icols * 6, mag_vals=lk.mag_vals.repeat(1, 6),
                               mag_uncs=lk.mag_uncs.repeat(1, 6))
    with pytest.raises(ValueError, match="16 bands"):
        catalog_lnlike_cuda(p, wide)
    with pytest.raises(ValueError):
        catalog_lnlike_cuda(p.float(), lk)  # tables in another dtype
    with pytest.raises(ValueError):
        catalog_lnlike_cuda(p[: S - 1], lk)  # another star count
    with pytest.raises(ValueError):
        catalog_lnlike_cuda(p[..., :4], lk)


def test_catalog_lnpost_on_card_matches_cpu(dev):
    """The fitter's lnpost_batch through the kernel on the card against the
    plain path on the CPU, float64; one call is one posterior launch, and
    the likelihood's dispatcher launches its own instantiation."""
    fitter, truths = _catalog(dev, 12)
    ic_cpu = get_ichrone("synthetic", device="cpu", **_SMALL)
    cpu = BatchStarFitter(ic_cpu, fitter.catalog, bands=CAT_BANDS)
    pars = catalog_points(ic_cpu, truths, 128, seed=6)
    before, before_ll = catalog_lnpost_cuda.launches, catalog_lnlike_cuda.launches
    got = fitter.lnpost_batch(pars).cpu().numpy()
    assert catalog_lnpost_cuda.launches == before + 1 and catalog_lnlike_cuda.launches == before_ll
    check_star("catalog lnpost", [got], [cpu.lnpost_batch(pars).numpy()], RTOL_STAR_F64)
    catalog_lnlike(torch.as_tensor(pars, device=dev), fitter._catalog_likelihood())
    assert catalog_lnlike_cuda.launches == before_ll + 1 and catalog_lnpost_cuda.launches == before + 1


def _check_lnpost_both(fitter, x, name, his=None):
    """The posterior kernel against ``catalog_lnpost_plain`` on ``x`` (S, B,
    5): float64 at rtol 1e-10, float32 tables, observations, constants and
    points (and the float32 box map's parameters) against the float64 plain
    version on the same float32 values; identical NaN and +-inf patterns."""
    dev = fitter.device
    lk64, pri64 = fitter._catalog_likelihood(), fitter._catalog_priors()
    x64 = torch.as_tensor(x, device=dev, dtype=torch.float64)
    h64 = None if his is None else torch.as_tensor(his, device=dev, dtype=torch.float64)
    got64 = catalog_lnpost_cuda(x64, lk64, pri64, h64)
    ref64 = catalog_lnpost_plain(x64, lk64, pri64, h64)
    assert (got64[1] is None) == (ref64[1] is None)
    pick = (lambda r: [r[0].cpu().numpy()] + ([] if r[1] is None else [r[1].cpu().numpy()]))
    check_star(f"f64 {name}", pick(got64), pick(ref64), RTOL_STAR_F64)
    lk32, pri32 = catalog_likelihood_as(lk64, torch.float32), catalog_priors_as(pri64, torch.float32)
    x32, h32 = x64.float(), None if h64 is None else h64.float()
    got32 = catalog_lnpost_cuda(x32, lk32, pri32, h32)
    p32 = x32 if h32 is None else unit_box(x32, pri32, h32)  # the box map in float32, as the kernel rounds it
    ref32 = catalog_lnpost_plain(p32.double(), catalog_likelihood_as(lk32, torch.float64),
                                 catalog_priors_as(pri32, torch.float64))
    check_star(f"f32 {name}", pick(got32), pick(ref32), RTOL_STAR_F32, ATOL_STAR_F32)
    return ref64[0].cpu().numpy()


@pytest.mark.parametrize("S,B", [(1, 1), (3, 31), (12, 64), (16, 200), (4, 1000), (64, 400), (256, 256), (256, 32),
                                 (16, 8000), (64, 4097)])
def test_catalog_lnpost_kernel_matches_plain(dev, S, B):
    """Batches inside one warp, one block and many, with a ragged last warp;
    the holes of ``catalog_table``; NaN, top-knot, off-grid and
    zero-distance points."""
    fitter, truths = _catalog(dev, S)
    pars = catalog_points(fitter.ic, truths, max(B, 8), seed=S + B)[:, :B]
    if B < 8:
        pars[:, -1, 2] = np.nan
    ref = _check_lnpost_both(fitter, pars, f"S={S} B={B}")
    if S * B >= 4096:
        assert np.isfinite(ref).sum() > 100 and np.isneginf(ref).sum() > 10


@pytest.mark.parametrize("reps,width", [(2, 8), (5, 16)])
@pytest.mark.parametrize("S,B", [(12, 64), (64, 400)])
def test_catalog_kernel_full_bc_table(dev, S, B, reps, width):
    """Six and fifteen bands (J, H, K repeated): the compact BC table's
    8- and 16-column instantiations of both wrappers."""
    fitter, truths = _catalog(dev, S)
    lk = fitter._catalog_likelihood()
    wide = dataclasses.replace(lk, band_icols=lk.band_icols * reps, mag_vals=lk.mag_vals.repeat(1, reps),
                               mag_uncs=lk.mag_uncs.repeat(1, reps))
    assert compact_bc(wide).shape[-1] == width
    fitter._likelihood = wide
    pars = catalog_points(fitter.ic, truths, B, seed=S + B + 1)
    _check_catalog_both(wide, pars, f"{3 * reps} bands S={S} B={B}")
    _check_lnpost_both(fitter, pars, f"{3 * reps} bands S={S} B={B}")


@pytest.mark.parametrize("kind", ["log", "compare", "searchsorted"])
def test_catalog_lnpost_kernel_axis_kinds(dev, kind):
    fitter, truths = _catalog(dev, 12)
    lk = fitter._catalog_likelihood()
    pack6, bc = star_grid_variant(lk.pack6, lk.bc, kind)
    fitter._likelihood = dataclasses.replace(lk, pack6=pack6, bc=bc)
    _check_lnpost_both(fitter, catalog_points(fitter.ic, truths, 300, seed=3), kind)


@pytest.mark.parametrize("S,B", [(12, 64), (256, 256)])
def test_catalog_lnpost_kernel_unit_cube(dev, S, B):
    """The nested fit's unit-cube form, the box map in the kernel: against
    the plain version's, and bitwise the box's parameters through the
    kernel in float64 (the map rounds as torch rounds it)."""
    fitter, truths = _catalog(dev, S)
    los, his = fitter._bounds_arrays()
    rng = np.random.default_rng(S + B)
    u = rng.uniform(0, 1, (S, B, 5))
    u[:, : B // 2] = np.clip((truths[:, None, :] - los) / (his - los)[:, None, :]
                             + rng.normal(0, 0.02, (S, B // 2, 5)), 0, 1)
    u[:, 0], u[:, 1] = 0.0, 1.0
    ref = _check_lnpost_both(fitter, u, f"unit cube S={S} B={B}", his=his)
    assert np.isfinite(ref).sum() > S
    ut, ht = torch.as_tensor(u, device=dev), torch.as_tensor(his, device=dev)
    lk, pri = fitter._catalog_likelihood(), fitter._catalog_priors()
    np.testing.assert_array_equal(catalog_lnpost_cuda(ut, lk, pri, ht)[0].cpu().numpy(),
                                  catalog_lnpost_cuda(unit_box(ut, pri, ht), lk, pri)[0].cpu().numpy())


def test_catalog_lnpost_kernel_replaced_priors(dev):
    """A prior of another class turns its flag off: the kernel leaves the
    term to the fitter (and returns orig_val for a replaced mass prior);
    the fitter's one launch plus torch terms matches the CPU fitter."""
    fitter, truths = _catalog(dev, 12)
    ic_cpu = get_ichrone("synthetic", device="cpu", **_SMALL)
    cpu = BatchStarFitter(ic_cpu, fitter.catalog, bands=CAT_BANDS)
    for f in (fitter, cpu):
        f.priors["age"] = GaussianPrior(9.0, 0.4, bounds=(6.5, 10.0))
        f.priors["mass"] = SalpeterPrior(bounds=(0.2, 5.0))
    assert fitter._catalog_priors().on == (False, True, True, False)
    pars = catalog_points(ic_cpu, truths, 128, seed=7)
    _check_lnpost_both(fitter, pars, "replaced priors")
    before = catalog_lnpost_cuda.launches
    got = fitter.lnpost_batch(pars).cpu().numpy()
    assert catalog_lnpost_cuda.launches == before + 1
    check_star("replaced priors lnpost_batch", [got], [cpu.lnpost_batch(pars).numpy()], RTOL_STAR_F64)


def test_catalog_lnpost_kernel_rejects_bad_input(dev):
    fitter, truths = _catalog(dev, 4)
    lk, pri = fitter._catalog_likelihood(), fitter._catalog_priors()
    p = torch.as_tensor(catalog_points(fitter.ic, truths, 16, seed=5), device=dev)
    his = torch.as_tensor(fitter._bounds_arrays()[1], device=dev)
    with pytest.raises(ValueError, match="points"):
        catalog_lnpost_cuda(p[..., :4], lk, pri)
    with pytest.raises(ValueError, match="his"):
        catalog_lnpost_cuda(p, lk, pri, his[:3])
    with pytest.raises(ValueError, match="his"):
        catalog_lnpost_cuda(p, lk, pri, his.float())
    with pytest.raises(ValueError, match="distance rows"):
        catalog_lnpost_cuda(p, lk, catalog_priors_as(pri, torch.float32))
    with pytest.raises(ValueError):
        catalog_lnpost_cuda(p.cpu(), lk, pri)


# ------------------------------------------------------------ kernel F


_GEN_DIMS = dict(n_feh=7, n_mass=30, n_eep=100, n_age=30)


def _forward_models(dev, kind="default"):
    """``(fm64, fm32, fm32 in float64)``: the track grid's forward model on the
    card, its float32 twin, and that twin's tables cast to float64 (the
    float32 kernel's reference); ``kind`` moves the model and BC axes so that
    every cell-location kind runs (``star_grid_variant``)."""
    out = []
    for dt in (torch.float64, torch.float32):
        fm = get_ichrone("synthetic", device=dev, dtype=dt, **_GEN_DIMS).track._forward_model
        if kind != "default":
            model, bc = star_grid_variant(fm.model, fm.bc, kind)
            packed = dataclasses.replace(fm.model_packed, knots=model.knots, axis_maps=model.axis_maps)
            fm = dataclasses.replace(fm, model=model, model_packed=packed, bc=bc)
        out.append(fm)
    fm32 = out[1]
    up = dataclasses.replace(fm32, model=grid_as(fm32.model, torch.float64),
                             model_packed=grid_as(fm32.model_packed, torch.float64), bc=grid_as(fm32.bc, torch.float64),
                             eep_support=tuple(x.double() if x.is_floating_point() else x for x in fm32.eep_support))
    return out[0], fm32, up


def _check_forms(dev, fms, n, icols, bcols, seed=0):
    from isochrones_torch.ops.eep import interp_eep
    from isochrones_torch.ops.generate import generate_plain
    from isochrones_torch.ops.generate_cuda import generate_cuda, get_eep_cuda

    fm64, fm32, up = fms
    track = get_ichrone("synthetic", device=dev, **_GEN_DIMS).track
    # a seeded subset of a larger spread (which holds every knot, NaN rows, ages past track ends)
    keep = np.random.default_rng(seed).permutation(max(n, 400))[:n]
    x64 = [torch.as_tensor(c[keep], device=dev) for c in generate_points(track, max(n, 400), seed)]
    x32, x32up = [x.float() for x in x64], [x.float().double() for x in x64]
    given = torch.as_tensor(np.random.default_rng(seed).uniform(-3.0, 104.0, n), device=dev)
    for all_As in (False, True):
        check_generate("f64", generate_cuda(fm64, *x64, icols, bcols, all_As=all_As),
                       generate_plain(fm64, *x64, icols, bcols, all_As=all_As), "float64")
        got = generate_cuda(fm32, *x32, icols, bcols, all_As=all_As)
        e_ref = interp_eep(x32up[1], x32up[2], x32up[0], *up.eep_support, eep0=up.eep0)
        ref = generate_plain(up, *x32up, icols, bcols, eeps=got[0].double(), all_As=all_As)
        check_generate("f32", got, (e_ref,) + tuple(ref[1:]), "float32")
        check_generate("f64 given", generate_cuda(fm64, *x64, icols, bcols, eeps=given, all_As=all_As),
                       generate_plain(fm64, *x64, icols, bcols, eeps=given, all_As=all_As), "float64")
        check_generate("f32 given", generate_cuda(fm32, *x32, icols, bcols, eeps=given.float(), all_As=all_As),
                       generate_plain(up, *x32up, icols, bcols, eeps=given.float().double(), all_As=all_As), "float32")
    e64 = get_eep_cuda(fm64, *x64[:3])
    assert torch.equal(e64.nan_to_num(-1.0), interp_eep(x64[1], x64[2], x64[0], *fm64.eep_support,
                                                        eep0=fm64.eep0).nan_to_num(-1.0))
    assert torch.equal(get_eep_cuda(fm32, *x32[:3]).nan_to_num(-1.0), got[0].nan_to_num(-1.0))
    assert int(torch.isfinite(e64).sum()) > n // 5 or n < 200


@pytest.mark.parametrize("n", [1, 31, 1000, 70001])
@pytest.mark.parametrize("cols", ["all", "none", "some"])
def test_generate_kernel_matches_plain(dev, n, cols):
    fms = _forward_models(dev)
    model = fms[0].model
    icols = {"all": model.icols("all"), "none": (), "some": model.icols(["radius", "Teff", "eep"])}[cols]
    _check_forms(dev, fms, n, icols, tuple(fms[0].bc.column_index[b] for b in ("J", "G", "W3")), seed=n)


@pytest.mark.parametrize("n_bands", [0, 1, 3, 4, 5, 11, 16])
def test_generate_kernel_band_widths(dev, n_bands):
    """Every compact-table width (4, 8, 16; bands repeated past the table's 11)."""
    fms = _forward_models(dev)
    bcols = tuple(list(range(fms[0].bc.values.shape[-1])) * 2)[:n_bands]
    _check_forms(dev, fms, 5000, fms[0].model.icols(["logg", "age"]), bcols, seed=n_bands)


@pytest.mark.parametrize("kind", ["compare", "searchsorted"])
def test_generate_kernel_axis_kinds(dev, kind):
    """The track grid as built has affine [Fe/H], log mass and exact-affine
    EEP axes; these move the mass axis to irregular knots, or drop the maps."""
    fms = _forward_models(dev, kind)
    _check_forms(dev, fms, 20000, fms[0].model.icols("all"), (0, 3, 7), seed=3)


def test_generate_kernel_caps_and_bad_input(dev):
    """The caps raise a ValueError that names them; bad tensors are refused;
    nothing falls back to the plain version."""
    from isochrones_torch.ops.generate_cuda import MAX_BANDS, MAX_PROPS, generate_cuda, get_eep_cuda

    fm64, fm32, _ = _forward_models(dev)
    x = torch.ones(8, device=dev, dtype=torch.float64)
    with pytest.raises(ValueError, match=f"at most {MAX_PROPS} model columns"):
        generate_cuda(fm64, x, x, x, x, x, (0,) * (MAX_PROPS + 1), (0,))
    with pytest.raises(ValueError, match=f"at most {MAX_BANDS} bands"):
        generate_cuda(fm64, x, x, x, x, x, (0,), (0,) * (MAX_BANDS + 1))
    huge = x[:1].expand(1 << 31)
    with pytest.raises(ValueError, match=r"N < 2\*\*31"):
        get_eep_cuda(fm64, huge, huge, huge)
    with pytest.raises(ValueError):
        generate_cuda(fm32, x, x, x, x, x, (0,), (0,))  # tables in another dtype
    with pytest.raises(ValueError):
        generate_cuda(fm64, x, x[:7], x, x, x, (0,), (0,))  # another length
    with pytest.raises(ValueError, match="outside the table"):
        generate_cuda(fm64, x, x, x, x, x, (99,), (0,))
    e, p, m, m0 = generate_cuda(fm64, x[:0], x[:0], x[:0], x[:0], x[:0], (0,), (0,), all_As=True)
    assert e.shape == (0,) and p.shape == (0, 1) and m0.shape == (0, 1)


def test_interpolators_launch_generate_kernel(dev):
    """``generate``, ``generate_device``, ``generate_binary``, a population
    and the fast ``get_eep`` on the card go through the kernel and equal the
    CPU's plain path (float64)."""
    from isochrones_torch.ops.generate_cuda import generate_cuda, get_eep_accurate_cuda, get_eep_cuda
    from isochrones_torch.populations import StarPopulation

    card = get_ichrone("synthetic", device=dev, **_GEN_DIMS)
    cpu = get_ichrone("synthetic", device="cpu", **_GEN_DIMS)
    cols = generate_points(cpu.track, 3000, seed=9)
    generate_cuda.launches = get_eep_cuda.launches = get_eep_accurate_cuda.launches = 0
    got = card.generate(*cols[:3], distance=cols[3], AV=cols[4], all_As=True)
    ref = cpu.generate(*cols[:3], distance=cols[3], AV=cols[4], all_As=True)
    eeps = card.track.get_eep(*cols[:3])
    acc = card.track.get_eep(*cols[:3], accurate=True)
    dev_out = card.generate_device(*cols[:3], distance=cols[3], AV=cols[4])
    assert generate_cuda.launches == 2 and get_eep_cuda.launches == 1 and get_eep_accurate_cuda.launches == 1
    assert list(got) == list(ref)
    for c in ref:
        np.testing.assert_allclose(got[c], ref[c], rtol=1e-10, atol=1e-9, equal_nan=True, err_msg=c)
    np.testing.assert_array_equal(eeps, cpu.track.get_eep(*cols[:3]))
    np.testing.assert_allclose(acc, cpu.track.get_eep(*cols[:3], accurate=True), rtol=0, atol=1e-9)
    np.testing.assert_allclose(dev_out[2].cpu().numpy(), np.stack([ref[f"{b}_mag"] for b in card.bands], -1),
                               rtol=1e-10, equal_nan=True)
    pops = [StarPopulation(ic.track, imf=SalpeterPrior(bounds=(0.4, 2.5)), feh=GaussianPrior(-0.1, 0.15))
            .generate(300, rng=5) for ic in (card, cpu)]
    assert generate_cuda.launches >= 3
    for c in pops[1]:
        np.testing.assert_allclose(pops[0][c], pops[1][c], rtol=1e-10, atol=1e-9, equal_nan=True, err_msg=c)


# ------------------------------------------------------------ kernel F's accurate forms


def _eep_axis_variant(grid, kind):
    """``grid`` with its EEP axis (the last) moved so that each cell-location
    kind runs on it: "exact_affine" as built, "affine" (the knots scaled by
    0.37: uniform, not bit-exact), "log" (log-uniform), "compare"
    (irregular), "searchsorted" (no axis maps). Values are kept."""
    from isochrones_torch.ops.interp import compute_axis_maps

    if kind == "exact_affine":
        return grid
    maps = tuple(grid.axis_maps)
    if kind == "searchsorted":
        return dataclasses.replace(grid, axis_maps=maps[:2] + (None,))
    k = grid.knots[-1].cpu().double().numpy()
    if kind == "affine":
        k = k * 0.37
    elif kind == "log":
        k = np.exp(np.linspace(np.log(k[0]), np.log(k[-1]), len(k)))
    else:
        d = np.diff(k) * (1.0 + 0.5 * np.sin(np.arange(len(k) - 1)))
        k = k[0] + (k[-1] - k[0]) * np.concatenate([[0.0], np.cumsum(d)]) / d.sum()
    amap = compute_axis_maps([k])[0]
    assert amap[0] == kind, amap
    v = grid.values
    return dataclasses.replace(grid, knots=grid.knots[:2] + (torch.as_tensor(k, dtype=v.dtype, device=v.device),),
                               axis_maps=maps[:2] + (amap,))


def _accurate_points(dev, n, seed, dtype):
    """Seeded (mass, age, feh, distance, AV) on the card: the smoke's spread
    (every knot, NaN rows, ages past every track's end, whose fast estimate is
    NaN so that the scan runs)."""
    track = get_ichrone("synthetic", device="cpu", **_GEN_DIMS).track
    keep = np.random.default_rng(seed).permutation(max(n, 400))[:n]
    return [torch.as_tensor(c[keep], device=dev, dtype=dtype) for c in generate_points(track, max(n, 400), seed)]


@pytest.mark.parametrize("n", [1, 31, 1000, 70001])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_accurate_forms_match_plain(dev, n, dtype):
    """The accurate forward form and the accurate EEP alone on the track grid
    against the plain Newton step (``check_newton``); the columns and
    magnitudes at the kernel's own EEPs to ``check_generate``'s tolerances."""
    from isochrones_torch.ops.generate import generate_plain
    from isochrones_torch.ops.generate_cuda import generate_accurate_cuda, get_eep_accurate_cuda

    fm64, fm32, up = _forward_models(dev)
    fm, dtn = (fm64, "float64") if dtype == torch.float64 else (fm32, "float32")
    x = _accurate_points(dev, n, n, dtype)
    icols, bcols = fm.model.icols("all"), tuple(fm.bc.column_index[b] for b in ("J", "G", "W3"))
    got = generate_accurate_cuda(fm, *x, icols, bcols, all_As=True)
    ref_e, ref_r, resid_at = plain_accurate(fm, *x[:3])
    check_newton("accurate generate", got[0].cpu(), ref_e.cpu(), ref_r.cpu(), dtn, resid_at)
    xr = [c.double() for c in x]
    ref = generate_plain(fm64 if dtype == torch.float64 else up, *xr, icols, bcols, eeps=got[0].double(), all_As=True)
    check_generate("accurate columns", got, (got[0],) + tuple(ref[1:]), dtn)
    assert torch.equal(get_eep_accurate_cuda(fm, *x[:3]).nan_to_num(-1.0), got[0].nan_to_num(-1.0))
    if n >= 1000:
        assert int(torch.isfinite(got[0]).sum()) > n // 5 and int(torch.isnan(ref_e).sum()) > 0


@pytest.mark.parametrize("kind", ["compare", "searchsorted"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_accurate_forms_axis_kinds(dev, kind, dtype):
    """The track grid's accurate forms with the mass axis on irregular knots,
    or with no axis maps (the EEP axis then searchsorted, whose searches
    vote across the warp)."""
    from isochrones_torch.ops.generate_cuda import get_eep_accurate_cuda

    fm64, fm32, _ = _forward_models(dev, kind)
    fm, dtn = (fm64, "float64") if dtype == torch.float64 else (fm32, "float32")
    x = _accurate_points(dev, 20000, 5, dtype)
    ref_e, ref_r, resid_at = plain_accurate(fm, *x[:3])
    check_newton(f"accurate EEP {kind}", get_eep_accurate_cuda(fm, *x[:3]).cpu(), ref_e.cpu(), ref_r.cpu(), dtn,
                 resid_at)


@pytest.mark.parametrize("kind", ["exact_affine", "affine", "log", "compare", "searchsorted"])
@pytest.mark.parametrize("n", [1, 31, 1000, 70001])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_newton_form_matches_plain(dev, kind, n, dtype):
    """The Newton form on the isochrone grid (initial mass), its EEP axis of
    every cell-location kind, from seeds at 300 (past this grid's top EEP:
    clamped), inside the grid and NaN (the scan runs), against the plain
    Newton step."""
    from isochrones_torch.ops.generate import NewtonGrid
    from isochrones_torch.ops.generate_cuda import eep_newton_cuda

    iso = get_ichrone("synthetic", device=dev, dtype=dtype, **_GEN_DIMS)
    ng = NewtonGrid(_eep_axis_variant(iso.model, kind), iso.model.column_index["initial_mass"])
    x = _accurate_points(dev, n, n + 1, dtype)
    e = ng.grid.knots[-1]
    seed = torch.as_tensor(np.random.default_rng(n).uniform(float(e[0]), float(e[-1]), n), device=dev, dtype=dtype)
    seed[::3], seed[1::3] = 300.0, float("nan")
    ref_e, ref_r, resid_at = plain_newton(ng, seed, *x[:3])
    dtn = "float64" if dtype == torch.float64 else "float32"
    got = eep_newton_cuda(ng, seed, *x[:3])
    check_newton(f"Newton form {kind}", got.cpu(), ref_e.cpu(), ref_r.cpu(), dtn, resid_at)
    if n >= 1000:
        assert int(torch.isfinite(got).sum()) > n // 10


def test_accurate_entry_points_one_launch(dev):
    """``get_eep(accurate=True)`` on both grids, ``generate(accurate=True)``
    and ``model_mag`` (accurate and approximate) on the card are one launch
    of kernel F each, by the wrappers' counters, and equal the CPU's plain
    path (float64: EEPs to 1e-9 with identical NaN patterns)."""
    card = get_ichrone("synthetic", device=dev, **_GEN_DIMS)
    cpu = get_ichrone("synthetic", device="cpu", **_GEN_DIMS)
    cols = generate_points(cpu.track, 5000, seed=11)
    m, a, f, d, av = cols
    for label, fn, ref in (
        ("track get_eep", lambda ic: ic.track.get_eep(m, a, f, accurate=True), None),
        ("iso get_eep", lambda ic: ic.get_eep(m, a, f, accurate=True), None),
        ("generate", lambda ic: ic.generate(m, a, f, distance=d, AV=av, accurate=True)["J_mag"], None),
        ("model_mag", lambda ic: ic.model_mag(m, a, f, distance=d, AV=av), None),
        ("model_mag approx", lambda ic: ic.model_mag(m, a, f, distance=d, AV=av, approx=True), None),
        ("model_value", lambda ic: ic.model_value(m, a, f, ["radius", "Teff"]), None),
    ):
        out = []
        assert wrapper_launches(lambda: out.append(fn(card)), reps=1) == 1, label
        got, want = np.asarray(out[0]), np.asarray(fn(cpu))
        if "get_eep" in label:
            check_eep(label, got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9, equal_nan=True, err_msg=label)


def test_accurate_forms_caps_and_bad_input(dev):
    """The new forms' caps raise a ValueError that names them: N < 2**31,
    28 columns, 16 bands, a 3-d grid, the matched column inside the table,
    the track grid's axes and age column; nothing falls back."""
    from isochrones_torch.ops.generate import NewtonGrid
    from isochrones_torch.ops.generate_cuda import (
        MAX_BANDS, MAX_PROPS, eep_newton_cuda, generate_accurate_cuda, get_eep_accurate_cuda,
    )

    fm64, fm32, _ = _forward_models(dev)
    iso = get_ichrone("synthetic", device=dev, **_GEN_DIMS)
    x = torch.ones(8, device=dev, dtype=torch.float64)
    huge = x[:1].expand(1 << 31)
    with pytest.raises(ValueError, match=f"at most {MAX_PROPS} model columns"):
        generate_accurate_cuda(fm64, x, x, x, x, x, (0,) * (MAX_PROPS + 1), (0,))
    with pytest.raises(ValueError, match=f"at most {MAX_BANDS} bands"):
        generate_accurate_cuda(fm64, x, x, x, x, x, (0,), (0,) * (MAX_BANDS + 1))
    for fn in (lambda: get_eep_accurate_cuda(fm64, huge, huge, huge),
               lambda: eep_newton_cuda(NewtonGrid(iso.model, 0), huge, huge, huge, huge)):
        with pytest.raises(ValueError, match=r"N < 2\*\*31"):
            fn()
    with pytest.raises(ValueError, match="3-d grid"):
        eep_newton_cuda(NewtonGrid(iso.bc, 0), x, x, x, x)
    with pytest.raises(ValueError, match="outside the table"):
        eep_newton_cuda(NewtonGrid(iso.model, 999), x, x, x, x)
    with pytest.raises(ValueError, match="grid axes"):
        get_eep_accurate_cuda(dataclasses.replace(fm64, index_order=(1, 2, 0, 3, 4)), x, x, x)
    with pytest.raises(ValueError, match="age column"):
        get_eep_accurate_cuda(dataclasses.replace(fm64, i_age=-1), x, x, x)
    with pytest.raises(ValueError):
        get_eep_accurate_cuda(fm32, x, x, x)  # tables in another dtype
    assert get_eep_accurate_cuda(fm64, x[:0], x[:0], x[:0]).shape == (0,)


# ------------------------------------------------- grids read from MIST files


@pytest.fixture(scope="module")
def mist_root(tmp_path_factory):
    """A small tree of MIST-format files (``isochrones_torch.grids.mist_files``):
    three [Fe/H]s, five 200-EEP tracks a [Fe/H] (one cut short and
    completed by the pipeline), four isochrone ages, UBVRIplus and WISE on
    wide BC axes; the MIST classes pointed at it."""
    import isochrones_torch.config as tconfig
    import isochrones_torch.grids.mist as tmist
    from isochrones_torch.grids.mist_files import make_full_mist_tree

    root = str(tmp_path_factory.mktemp("mist_files"))
    fehs = (-0.5, 0.0, 0.25)
    make_full_mist_tree(root, track_kwargs=dict(fehs=fehs, masses=(0.7, 0.8, 0.9, 1.0, 1.2), short={(0.0, 0.9): 150},
                                                n_eep=200),
                        iso_kwargs=dict(fehs=fehs, ages=(8.0, 8.5, 9.0, 9.5), n_eep=200),
                        bc_kwargs=dict(fehs=(-1.0, -0.5, 0.0, 0.5), teffs=tuple(np.linspace(2500.0, 12000.0, 20)),
                                       loggs=(0.0, 1.5, 3.0, 4.5, 6.0), avs=(0.0, 0.5, 1.0, 2.0)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tconfig, "ISOCHRONES", root)
        mp.setattr(tmist.MISTModelGrid, "max_eep", lambda self, m, feh: 200)
        mp.setattr(tmist.MISTModelGrid, "fehs", np.array(fehs))
        mp.setattr(tmist.MISTModelGrid, "n_eep", 200)
        yield root


_MIST_BANDS = ["J", "H", "K", "G", "W1"]


def _mist(dev, dtype=torch.float64):
    return get_ichrone("mist", bands=_MIST_BANDS, device=dev, dtype=dtype)


def test_mist_grids_on_card_equal_cpu(dev, mist_root):
    """``get_ichrone("mist")`` on the card holds the CPU build's tables, bit
    for bit (and in float32 their float32 rounding)."""
    card, cpu = _mist(dev), _mist("cpu")
    for a, b in ((card, cpu), (card.track, cpu.track)):
        for g, h in ((a.model, b.model), (a.bc, b.bc)):
            assert torch.equal(g.values.cpu().nan_to_num(-9.0), h.values.nan_to_num(-9.0))
            assert g.axis_maps == h.axis_maps
    for x, y in zip(card.track.eep_support, cpu.track.eep_support):
        assert torch.equal(x.cpu(), y)
    f32 = _mist(dev, torch.float32)
    assert torch.equal(f32.model.values.cpu().nan_to_num(-9.0), cpu.model.values.float().nan_to_num(-9.0))


@pytest.mark.parametrize("B", [1024, 70001])
def test_mist_star_kernel_matches_plain(dev, mist_root, B):
    """The star kernel on the MIST-read isochrone grid (NaN padding, ragged
    EEP rows), a binary with 4 bands, in the grid's box with adversarial
    rows: float64 and float32 against the plain version."""
    ic64, ic32 = _mist(dev), _mist(dev, torch.float32)
    obs = star_observations(ic64, (60.0, 50.0, 9.0, 0.0, 200.0, 0.1))
    lk64 = BinaryStarModel(ic64, **obs)._star_likelihood()
    lk32 = BinaryStarModel(ic32, **obs)._star_likelihood()
    lk32up = dataclasses.replace(lk32, pack6=grid_as(lk32.pack6, torch.float64), bc=grid_as(lk32.bc, torch.float64))
    p64 = torch.as_tensor(star_points(ic64.model.knots, 2, B, seed=B), device=dev, dtype=torch.float64)
    ref = [x.cpu().numpy() for x in star_lnlike_fused_plain(p64, lk64)]
    check_star("mist f64", [x.cpu().numpy() for x in star_lnlike_cuda(p64, lk64)], ref, RTOL_STAR_F64)
    p32 = p64.float()
    check_star("mist f32", [x.cpu().numpy() for x in star_lnlike_cuda(p32, lk32)],
               [x.cpu().numpy() for x in star_lnlike_fused_plain(p32.double(), lk32up)], RTOL_STAR_F32, ATOL_STAR_F32)
    assert np.isfinite(ref[0]).sum() > B // 20


def test_mist_tree_kernel_matches_plain(dev, mist_root):
    """The tree kernel on the MIST-read isochrone grid, a model of three
    stars of one system."""
    mod = StarModel(_mist(dev), N=3, Teff=(5800, 100), logg=(4.4, 0.1), parallax=(5.0, 0.05), **_TREE_PHOT)
    _tree_check("mist N3", mod._get_fn("lnlike").likelihood, _tree_pts(mod, 4097, seed=5), dev)


@pytest.mark.parametrize("n", [31, 20001])
def test_mist_generate_kernel_matches_plain(dev, mist_root, n):
    """Kernel F on the MIST-read track grid (18 columns with
    ``interpolated``; a completed track): every form against the plain
    version, and the accurate inversion on both grids."""
    from isochrones_torch.ops.generate_cuda import eep_newton_cuda, generate_accurate_cuda

    track64, track32 = _mist(dev).track, _mist(dev, torch.float32).track
    fm64, fm32 = track64._forward_model, track32._forward_model
    up = dataclasses.replace(fm32, model=grid_as(fm32.model, torch.float64),
                             model_packed=grid_as(fm32.model_packed, torch.float64), bc=grid_as(fm32.bc, torch.float64),
                             eep_support=tuple(x.double() if x.is_floating_point() else x for x in fm32.eep_support))
    assert len(fm64.model.columns) == 18 and "interpolated" in fm64.model.columns
    icols = fm64.model.icols("all")
    _check_mist_forms(dev, (fm64, fm32, up), track64, n, icols, tuple(fm64.bc.column_index[b] for b in _MIST_BANDS))
    cols = [torch.as_tensor(c, device=dev) for c in _mist_points(track64, n, seed=n)]
    for dtn, fm, ic in (("float64", fm64, _mist(dev)), ("float32", fm32, _mist(dev, torch.float32))):
        x = [c.to(fm.model.values.dtype) for c in cols]
        ref_e, ref_r, resid_at = plain_accurate(fm, *x[:3])
        got = generate_accurate_cuda(fm, *x, icols, (0, 1))
        check_newton(f"mist accurate {dtn}", got[0].cpu(), ref_e.cpu(), ref_r.cpu(), dtn, resid_at)
        check_newton(f"mist track get_eep {dtn}", ic.track.get_eep_batch(*x[:3], accurate=True).cpu(), ref_e.cpu(),
                     ref_r.cpu(), dtn, resid_at)
        seed = torch.full_like(x[0], 100.0)
        ref_e, ref_r, resid_at = plain_newton(ic._newton_grid, seed, *x[:3])
        check_newton(f"mist iso Newton {dtn}", eep_newton_cuda(ic._newton_grid, seed, *x[:3]).cpu(), ref_e.cpu(),
                     ref_r.cpu(), dtn, resid_at)


def _mist_points(track, n, seed):
    """(mass, age, feh, distance, AV) on and past the small MIST tree's box,
    with every mass and [Fe/H] knot and a NaN in each coordinate."""
    rng = np.random.default_rng(seed)
    m = max(n, 40)
    mass, age = rng.uniform(0.65, 1.25, m), rng.uniform(7.5, 10.2, m)
    feh, dist, av = rng.uniform(-0.6, 0.3, m), rng.uniform(10.0, 2000.0, m), rng.uniform(0.0, 1.5, m)
    k = len(track.masses)
    mass[:k] = track.masses
    feh[k: k + len(track.fehs)] = track.fehs
    mass[-1], age[-2], feh[-3] = np.nan, np.nan, np.nan
    keep = rng.permutation(m)[:n]
    return [c[keep] for c in (mass, age, feh, dist, av)]


def _check_mist_forms(dev, fms, track, n, icols, bcols):
    from isochrones_torch.ops.eep import interp_eep
    from isochrones_torch.ops.generate import generate_plain
    from isochrones_torch.ops.generate_cuda import generate_cuda

    fm64, fm32, up = fms
    x64 = [torch.as_tensor(c, device=dev) for c in _mist_points(track, n, seed=n + 1)]
    x32, x32up = [x.float() for x in x64], [x.float().double() for x in x64]
    given = torch.as_tensor(np.random.default_rng(n).uniform(-3.0, 204.0, n), device=dev)
    check_generate("mist f64", generate_cuda(fm64, *x64, icols, bcols, all_As=True),
                   generate_plain(fm64, *x64, icols, bcols, all_As=True), "float64")
    got = generate_cuda(fm32, *x32, icols, bcols)
    e_ref = interp_eep(x32up[1], x32up[2], x32up[0], *up.eep_support, eep0=up.eep0)
    check_generate("mist f32", got, (e_ref,) + tuple(generate_plain(up, *x32up, icols, bcols, eeps=got[0].double())[1:]),
                   "float32")
    check_generate("mist f64 given", generate_cuda(fm64, *x64, icols, bcols, eeps=given),
                   generate_plain(fm64, *x64, icols, bcols, eeps=given), "float64")


def test_mist_entry_points_on_card(dev, mist_root):
    """``isochrone``, ``generate`` (one launch) and ``interp_mag`` on the
    MIST-read grids on the card equal the CPU's, float64."""
    card, cpu = _mist(dev), _mist("cpu")
    for age, feh in ((8.5, 0.0), (9.2, -0.3)):
        a, b = card.isochrone(age, feh=feh), cpu.isochrone(age, feh=feh)
        assert a.columns == b.columns and len(a["eep"]) == len(b["eep"]) > 20
        for c in b.columns:
            np.testing.assert_allclose(a[c], b[c], rtol=1e-9, atol=1e-9, err_msg=c)
    m, a_, f, d, av = _mist_points(cpu.track, 3000, seed=9)
    out = []
    assert wrapper_launches(lambda: out.append(card.generate(m, a_, f, distance=d, AV=av)), reps=1) == 1
    want = cpu.generate(m, a_, f, distance=d, AV=av)
    for c in want.columns:
        np.testing.assert_allclose(out[0][c], want[c], rtol=1e-9, atol=1e-9, equal_nan=True, err_msg=c)


# --------------------------------------------- the joint isochrone + track model


def _isotrack(dev, grid, request, dtype=torch.float64):
    """``IsoTrackModel`` on the small synthetic pair or the small MIST-read
    pair, a star with Teff, logg, [Fe/H], 4 bands and a parallax."""
    from isochrones_torch import IsoTrackModel

    if grid == "mist":
        request.getfixturevalue("mist_root")
        iso, track = _mist(dev, dtype), get_ichrone("mist", bands=_MIST_BANDS, tracks=True, device=dev, dtype=dtype)
        truth = (100.0, 9.0, 0.0, 200.0, 0.1)
    else:
        iso = get_ichrone("synthetic", device=dev, dtype=dtype, **_SMALL)
        track = get_ichrone("synthetic", tracks=True, device=dev, dtype=dtype, **_SMALL)
        truth = (60.0, 9.0, 0.0, 200.0, 0.1)
    return IsoTrackModel(iso, track, **isotrack_observations(iso, truth))


@pytest.mark.parametrize("B", [1, 31, 1024, 4097])
@pytest.mark.parametrize("grid", ["synthetic", "mist"])
def test_star_kernel_on_track_grid(dev, grid, B, request):
    """The star kernel with the track's index order (2, 0, 1, 3, 4), its mass
    axis and the parallax, at (mass, eep, feh, distance, AV) gathered from
    ``isotrack_points`` (exact, top and bottom knots of both grids, past
    either grid, NaN): float64 and float32 against the plain version."""
    model = _isotrack(dev, grid, request)
    lk = model._star_likelihoods()[1]
    assert lk.index_order == (2, 0, 1, 3, 4) and lk.parallax is not None
    pts = isotrack_points(model, B, seed=B)[:, list(model._TRACK_COLUMNS)]
    _check_star_both(lk, pts, f"track {grid} B={B}")


@pytest.mark.parametrize("grid", ["synthetic", "mist"])
def test_isotrack_lnpost_on_card(dev, grid, request):
    """``IsoTrackModel.lnpost_batch`` on the card (two launches a call, the
    composed likelihood never called) against the CPU's, float64, rtol
    1e-10; float32 against the same posterior with the plain likelihood in
    float64 on the float32 tables (``isotrack_reference``)."""
    import isochrones_torch.starmodel as star_mod

    gpu = _isotrack(dev, grid, request)
    cpu = _isotrack("cpu", grid, request)
    pts = isotrack_points(cpu, 2048, seed=5)
    ref = cpu.lnpost_batch(pts).numpy()
    real = star_mod.star_lnlike

    def no_composed(*a, **k):
        raise AssertionError("the composed likelihood was called")

    star_mod.star_lnlike = no_composed
    try:
        before = star_lnlike_cuda.launches
        got = gpu.lnpost_batch(pts).cpu().numpy()
        assert star_lnlike_cuda.launches == before + 2
    finally:
        star_mod.star_lnlike = real
    check_star(f"isotrack {grid} f64", [got], [ref], RTOL_STAR_F64)
    assert np.isfinite(ref).sum() > 200 and np.isneginf(ref).sum() > 100

    m32 = _isotrack(dev, grid, request, torch.float32)
    x = torch.as_tensor(pts, device=dev, dtype=torch.float32)
    ref32 = isotrack_reference(m32, x).cpu().numpy()
    check_star(f"isotrack {grid} f32", [m32.lnpost_batch(x).cpu().numpy()], [ref32], RTOL_STAR_F32, ATOL_STAR_F32)


@pytest.mark.parametrize("grid", ["synthetic", "mist"])
def test_isotrack_other_prior_keeps_two_launches_on_card(dev, grid, request):
    """With a subclass's own ``_build_lnprior_batch``, or an EEP prior that
    is not the track's, ``lnpost_batch`` still takes both likelihoods from
    two launches of the star kernel and adds that prior: float64 against
    the composed plain path, rtol 1e-10."""
    import isochrones_torch.starmodel as star_mod
    from isochrones_torch import IsoTrackModel
    from isochrones_torch.priors import EEP_prior

    class OwnPrior(IsoTrackModel):
        def _build_lnprior_batch(self):
            return super()._build_lnprior_batch()

    base = _isotrack(dev, grid, request)
    own = OwnPrior(base.iso, base.track, **base.kwargs)
    other = IsoTrackModel(base.iso, base.track, **base.kwargs)
    other.set_prior(eep=EEP_prior(copy.copy(base.track), other._priors["age"], bounds=other.eep_bounds))
    pts = torch.as_tensor(isotrack_points(base, 2048, seed=6), device=dev)
    real = star_mod.star_lnlike

    def no_composed(*a, **k):
        raise AssertionError("the composed likelihood was called")

    for m in (own, other):
        ref = isotrack_reference(m, pts).cpu().numpy()
        star_mod.star_lnlike = no_composed
        try:
            before = star_lnlike_cuda.launches
            got = m.lnpost_batch(pts).cpu().numpy()
            assert star_lnlike_cuda.launches == before + 2
        finally:
            star_mod.star_lnlike = real
        check_star(f"isotrack {grid} {type(m).__name__} f64", [got], [ref], RTOL_STAR_F64)
        assert np.isfinite(ref).sum() > 200


def test_isotrack_without_pack6_raises_on_card(dev):
    """On the card a grid without the EEP-prior columns of the 6-column pack
    raises: no silent plain path."""
    from isochrones_torch import IsoTrackModel

    iso = get_ichrone("synthetic", device=dev, **_SMALL)
    track = copy.copy(get_ichrone("synthetic", tracks=True, device=dev, **_SMALL))
    track.model_packed6 = None
    model = IsoTrackModel(iso, track, **isotrack_observations(iso, (60.0, 9.0, 0.0, 200.0, 0.1)))
    with pytest.raises(ValueError, match="EEP-prior columns"):
        model.lnpost_batch(isotrack_points(model, 8, seed=0))


def test_track_grid_results_file_on_card(dev, mist_root, tmp_path):
    """A ``SingleStarModel`` on the MIST-read track grid: saved with samples,
    reloaded with no interpolator given onto the MIST track grid on the card
    (the repair of ``load_hdf``), with equal samples and posterior."""
    from isochrones_torch import SingleStarModel

    track = get_ichrone("mist", bands=_MIST_BANDS, tracks=True, device=dev)
    obs = isotrack_observations(_mist(dev), (100.0, 9.0, 0.0, 200.0, 0.1))
    m = SingleStarModel(track, name="track", **obs)
    rng = np.random.default_rng(0)
    draws = {"mass": rng.uniform(0.9, 1.1, 50), "eep": rng.uniform(80, 120, 50), "feh": rng.uniform(-0.2, 0.2, 50),
             "distance": rng.uniform(190, 210, 50), "AV": rng.uniform(0, 0.2, 50), "lnprob": rng.normal(size=50)}
    m._samples = draws
    path = str(tmp_path / "track.h5")
    m.save_hdf(path)
    back = SingleStarModel.load_hdf(path, device=dev)
    assert type(back.ic).__name__ == "EvolutionTrackInterpolator" and back.ic.grid_type is not None
    assert back.device.type == "cuda" and back.ic.model.values.shape == track.model.values.shape
    for c in draws:
        np.testing.assert_array_equal(back.samples[c], draws[c])
    p = np.stack([draws[c] for c in back.param_names], axis=-1)
    check_star("reloaded track model", [back.lnpost_batch(p).cpu().numpy()], [m.lnpost_batch(p).cpu().numpy()],
               RTOL_STAR_F64)


# ---- the backward kernels A' (star) and C' (tree)


def _plain_cot_grad(plain_fn, p, lk, cot):
    with torch.enable_grad():
        x = p.detach().clone().requires_grad_(True)
        (g,) = torch.autograd.grad(plain_fn(x, lk), x, grad_outputs=cot)
    return g


def _grad_both(kernel, plain_fn, lk64, lk32, lk32up, pts, n_out, name):
    """The backward kernel against autograd of the plain version: float64 at
    RTOL_GRAD_F64 of the row's scale, float32 against the float64 plain
    version on the same float32 values at RTOL_GRAD_F32; identical NaN and
    +-inf patterns (``chip_smoke.check_grad``)."""
    from chip_smoke import RTOL_GRAD_F32, RTOL_GRAD_F64, check_grad, grad_cotangents

    dev = lk64.model.values.device if hasattr(lk64, "model") else lk64.pack6.values.device
    p64 = torch.as_tensor(pts, device=dev, dtype=torch.float64)
    cot = grad_cotangents(len(pts), n_out, 3, dev, torch.float64)
    check_grad(f"f64 {name}", kernel(p64, lk64, *cot).cpu().numpy(),
               _plain_cot_grad(plain_fn, p64, lk64, cot).cpu().numpy(), RTOL_GRAD_F64)
    p32, cot32 = p64.float(), tuple(c.float() for c in cot)
    check_grad(f"f32 {name}", kernel(p32, lk32, *cot32).cpu().numpy(),
               _plain_cot_grad(plain_fn, p32.double(), lk32up, tuple(c.double() for c in cot32)).cpu().numpy(),
               RTOL_GRAD_F32)


#: A''s batches: the NUTS chains' 4 and 8, batches that leave idle lanes in
#: the last warp, and (at N = 2) one batch of each group width, 16 lanes up
#: to 8192 points, then 8, 4, 2 and 1 (the forward's rule, group_lanes)
_STAR_GRAD_BATCHES = [1, 4, 8, 31, 1024, 4097, 12000, 20000, 50000, 70000]


@pytest.mark.parametrize("B", _STAR_GRAD_BATCHES)
@pytest.mark.parametrize("kind", ["default", "log", "compare", "searchsorted"])
@pytest.mark.parametrize("N", [1, 2, 3])
def test_star_grad_kernel_matches_autograd(dev, N, kind, B):
    """A' against autograd of the plain version on adversarial points
    (knots, top knots, out of bounds, NaN, AV past the BC grid, distance <=
    0), every axis-map kind, batches that take every group width and that
    leave idle lanes in the last warp."""
    from isochrones_torch.ops.star_cuda import star_lnlike_grad_cuda

    lk = _likelihood(dev, torch.float64, N, kind)
    lk32 = dataclasses.replace(lk, pack6=grid_as(lk.pack6, torch.float32), bc=grid_as(lk.bc, torch.float32))
    lk32up = dataclasses.replace(lk, pack6=grid_as(lk32.pack6, torch.float64), bc=grid_as(lk32.bc, torch.float64))
    pts = star_points(lk.pack6.knots, N, B, seed=B + N)
    _grad_both(star_lnlike_grad_cuda, star_lnlike_fused_plain, lk, lk32, lk32up, pts, N, f"N={N} {kind} B={B}")


#: (components, batch, lanes a component): A' takes the forward's group
#: widths, 16 lanes (8 at N = 3) while B * NP * G stays within 2^18 threads
_STAR_GRAD_WIDTHS = [(2, 4, 16), (2, 8, 16), (2, 8192, 16), (2, 12000, 8), (2, 20000, 4), (2, 50000, 2),
                     (2, 70000, 1), (1, 16384, 16), (1, 20000, 8), (1, 140000, 1), (3, 4, 8), (3, 12000, 4),
                     (3, 70000, 1)]


@pytest.mark.parametrize("N,B,lanes", _STAR_GRAD_WIDTHS)
def test_star_grad_kernel_group_widths(dev, N, B, lanes):
    """A' and A take the group width that their one rule gives the batch (the
    library's own choice, ``star_cuda.launch_geometry``), and at that width A'
    agrees with autograd of the plain version."""
    from isochrones_torch.ops.star_cuda import launch_geometry, star_lnlike_grad_cuda

    lk = _likelihood(dev, torch.float64, N, "default")
    p = torch.as_tensor(star_points(lk.pack6.knots, N, B, seed=lanes), device=dev, dtype=torch.float64)
    assert launch_geometry(B, N) == ({1: 1, 2: 2, 3: 4}[N], lanes)
    lk32 = dataclasses.replace(lk, pack6=grid_as(lk.pack6, torch.float32), bc=grid_as(lk.bc, torch.float32))
    lk32up = dataclasses.replace(lk, pack6=grid_as(lk32.pack6, torch.float64), bc=grid_as(lk32.bc, torch.float64))
    _grad_both(star_lnlike_grad_cuda, star_lnlike_fused_plain, lk, lk32, lk32up, p.cpu().numpy(), N,
               f"N={N} B={B} G={lanes}")


@pytest.mark.parametrize("N,B", [(1, 4), (2, 8), (2, 1024), (2, 50000), (3, 777), (3, 70000)])
def test_star_grad_kernel_two_launches_bitwise_equal(dev, N, B):
    """A' has no atomics and sums in an order fixed by the launch geometry:
    two launches give the same bits, and a point's gradient does not depend
    on the points beside it."""
    from chip_smoke import grad_cotangents
    from isochrones_torch.ops.star_cuda import star_lnlike_grad_cuda

    lk64 = _likelihood(dev, torch.float64, N, "default")
    for dtype in (torch.float64, torch.float32):
        lk = lk64 if dtype == torch.float64 else dataclasses.replace(
            lk64, pack6=grid_as(lk64.pack6, dtype), bc=grid_as(lk64.bc, dtype))
        p = torch.as_tensor(star_points(lk64.pack6.knots, N, B, seed=9), device=dev, dtype=dtype)
        cot = grad_cotangents(B, N, 4, dev, dtype)
        first = star_lnlike_grad_cuda(p, lk, *cot).clone()
        second = star_lnlike_grad_cuda(p, lk, *cot)
        flipped = star_lnlike_grad_cuda(p.flip(0).contiguous(), lk, *(c.flip(0).contiguous() for c in cot)).flip(0)
        bits = torch.int64 if dtype == torch.float64 else torch.int32
        assert torch.equal(first.view(bits), second.view(bits))
        assert torch.equal(torch.nan_to_num(first, nan=-1.0), torch.nan_to_num(flipped, nan=-1.0))


@pytest.mark.parametrize("drop", [("logg",), ("J", "H", "K", "G"), ("parallax",)],
                         ids=["missing-channel", "no-bands", "no-parallax"])
def test_star_grad_kernel_observation_variants(dev, drop):
    from isochrones_torch.ops.star_cuda import star_lnlike_grad_cuda

    lk = _likelihood(dev, torch.float64, 2, "default", drop)
    lk32 = dataclasses.replace(lk, pack6=grid_as(lk.pack6, torch.float32), bc=grid_as(lk.bc, torch.float32))
    lk32up = dataclasses.replace(lk, pack6=grid_as(lk32.pack6, torch.float64), bc=grid_as(lk32.bc, torch.float64))
    _grad_both(star_lnlike_grad_cuda, star_lnlike_fused_plain, lk, lk32, lk32up,
               star_points(lk.pack6.knots, 2, 2048, seed=5), 2, f"drop {drop}")


def _finite_difference_points(lk, N, B, seed):
    """Seeded points well inside the bench box's scaled copy on the small
    grid, where the posterior is finite for most rows."""
    rng = np.random.default_rng(seed)
    eeps = lk.pack6.knots[2].cpu().numpy()
    pts = np.empty((B, N + 4))
    pts[:, :N] = np.sort(rng.uniform(eeps[0] + 0.2 * (eeps[-1] - eeps[0]), eeps[0] + 0.5 * (eeps[-1] - eeps[0]),
                                     (B, N)), axis=1)[:, ::-1]
    pts[:, N:] = np.array(_SMALL_TRUTH[-4:]) + rng.normal(0, [0.2, 0.15, 10.0, 0.05], (B, 4))
    pts[:, N + 3] = np.abs(pts[:, N + 3])
    return pts


@pytest.mark.parametrize("N", [1, 2, 3])
def test_star_grad_kernel_matches_finite_differences(dev, N):
    """A' (with g_ll = 1) against central finite differences of kernel A's
    ll in float64, step 1e-6 of each parameter's scale: rows whose two step
    sizes (h and h / 2) disagree cross a cell edge and are left out (at most
    5%); elsewhere within 1e-5 of the row's scale."""
    from chip_smoke import check_grad
    from isochrones_torch.ops.star_cuda import star_lnlike_grad_cuda

    lk = _likelihood(dev, torch.float64, N, "default")
    pts = _finite_difference_points(lk, N, 512, seed=N)
    p = torch.as_tensor(pts, device=dev, dtype=torch.float64)
    ll0 = star_lnlike_cuda(p, lk)[0]
    keep = torch.isfinite(ll0)
    g = star_lnlike_grad_cuda(p, lk, torch.ones_like(ll0), torch.zeros((len(p), N), device=dev, dtype=p.dtype),
                              torch.zeros((len(p), N), device=dev, dtype=p.dtype))
    scale = torch.tensor([1.0] * N + [0.01, 0.01, 1.0, 0.01], device=dev, dtype=p.dtype)

    def fd(h):
        cols = []
        for j in range(N + 4):
            e = torch.zeros_like(p)
            e[:, j] = h * scale[j]
            cols.append((star_lnlike_cuda(p + e, lk)[0] - star_lnlike_cuda(p - e, lk)[0]) / (2 * h * scale[j]))
        return torch.stack(cols, dim=1)

    f1, f2 = fd(1e-6), fd(5e-7)
    rowscale = torch.clamp(f1.abs().amax(dim=1), min=1.0)
    smooth = keep & (((f1 - f2).abs().amax(dim=1) / rowscale) < 1e-6)
    assert int(smooth.sum()) >= 0.95 * int(keep.sum()) and int(keep.sum()) > 100
    check_grad(f"A' vs finite differences N={N}", g[smooth].cpu().numpy(), f1[smooth].cpu().numpy(), 1e-5)


@pytest.mark.parametrize("B", [1, 31, 1024, 4097])
@pytest.mark.parametrize("case", ["single", "N2", "N3", "N5", "N16", "star3", "two_systems", "density"])
def test_tree_grad_kernel_matches_autograd(dev, case, B):
    """C' against autograd of the plain version on adversarial points (knots,
    top knots, one star off the grid, NaN), relative rows, density rows and
    limits, up to the 16-star cap."""
    from chip_smoke import tree_likelihood_as
    from isochrones_torch.ops.tree_cuda import tree_lnlike_grad_cuda

    mod = _tree_model(dev, case)
    lk = mod._get_fn("lnlike").likelihood
    lk32 = tree_likelihood_as(lk, torch.float32)
    _grad_both(tree_lnlike_grad_cuda, tree_lnlike_fused_plain, lk, lk32, tree_likelihood_as(lk32, torch.float64),
               _tree_pts(mod, B, seed=B), lk.n_stars, f"{case} B={B}")


def _tree_grad_case(dev, case, B, seed):
    """C' against autograd of the plain version (``_grad_both``) on the
    adversarial points of ``case`` at B points."""
    from chip_smoke import tree_likelihood_as
    from isochrones_torch.ops.tree_cuda import tree_lnlike_grad_cuda

    mod = _tree_model(dev, case)
    lk = mod._get_fn("lnlike").likelihood
    lk32 = tree_likelihood_as(lk, torch.float32)
    _grad_both(tree_lnlike_grad_cuda, tree_lnlike_fused_plain, lk, lk32, tree_likelihood_as(lk32, torch.float64),
               _tree_pts(mod, B, seed=seed), lk.n_stars, f"{case} B={B}")
    return lk


@pytest.mark.parametrize("B", [1, 4, 8, 33, 1024, 131072])
@pytest.mark.parametrize("case", ["single", "N2", "N3", "N4", "N5", "N6", "N7", "N8", "N11", "N12", "N16", "star3",
                                  "two_systems", "density"])
def test_tree_grad_kernel_batches(dev, case, B):
    """C' (a team of lanes a point) at 1 to 16 stars and the NUTS fits'
    batches (4, 8) up to 131072 points, against autograd of the plain
    version: relative rows, density rows and limits, adversarial points."""
    _tree_grad_case(dev, case, B, seed=B + 5)


@pytest.mark.parametrize("case,B,groups,lanes", _TREE_GEOMETRIES)
def test_tree_grad_kernel_launch_geometry(dev, case, B, groups, lanes):
    """C' at every team shape the launch geometry can choose (the forward's
    rule), at batches that leave a partial team and a partial warp."""
    from isochrones_torch.ops.tree_cuda import tree_lnlike_grad_cuda

    mod = _tree_model(dev, case)
    lk = mod._get_fn("lnlike").likelihood
    p = torch.as_tensor(_tree_pts(mod, B, seed=lanes), device=dev, dtype=torch.float64)
    g = torch.ones(B, device=dev, dtype=p.dtype)
    z = torch.zeros((B, lk.n_stars), device=dev, dtype=p.dtype)
    assert launch_geometry(B, lk.n_stars) == (groups, lanes)
    assert _group_widths(lambda: tree_lnlike_grad_cuda(p, lk, g, z, z), "tree_lnlike_grad_kernel") == {lanes}
    _tree_grad_case(dev, case, B, seed=lanes)


@pytest.mark.parametrize("case,B", [("star3", 8), ("star3", 1024), ("star3", 50000), ("N16", 777),
                                    ("two_systems", 12289), ("density", 33)])
def test_tree_grad_kernel_two_launches_bitwise_equal(dev, case, B):
    """C' has no atomics and sums in an order fixed by the launch geometry:
    two launches give the same bits, and a point's gradient does not depend
    on the points beside it."""
    from chip_smoke import grad_cotangents
    from isochrones_torch.ops.tree_cuda import tree_lnlike_grad_cuda

    mod = _tree_model(dev, case)
    lk = mod._get_fn("lnlike").likelihood
    for dtype in (torch.float64, torch.float32):
        which = lk if dtype == torch.float64 else _as_dtype(lk, dtype)
        p = torch.as_tensor(_tree_pts(mod, B, seed=9), device=dev, dtype=dtype)
        cot = grad_cotangents(B, lk.n_stars, 4, dev, dtype)
        first = tree_lnlike_grad_cuda(p, which, *cot).clone()
        second = tree_lnlike_grad_cuda(p, which, *cot)
        flipped = tree_lnlike_grad_cuda(p.flip(0).contiguous(), which, *(c.flip(0).contiguous() for c in cot)).flip(0)
        bits = torch.int64 if dtype == torch.float64 else torch.int32
        assert torch.equal(first.view(bits), second.view(bits))
        assert torch.equal(torch.nan_to_num(first, nan=-1.0), torch.nan_to_num(flipped, nan=-1.0))


def test_grad_dispatch_through_autograd_functions(dev):
    """On the card, autograd through the fused likelihoods and the models'
    posteriors runs kernels A' and C' (once a backward), and equals autograd
    of the plain path; the wrappers without a backward raise."""
    from chip_smoke import check_grad
    from isochrones_torch.ops.star_cuda import star_lnlike_grad_cuda
    from isochrones_torch.ops.tree_cuda import tree_lnlike_grad_cuda
    import isochrones_torch.starmodel as star_mod

    lk = _likelihood(dev, torch.float64, 2, "default")
    p = torch.as_tensor(star_points(lk.pack6.knots, 2, 1024, seed=9), device=dev, dtype=torch.float64)
    model = BinaryStarModel(get_ichrone("synthetic", device=dev, **_SMALL),
                            **star_observations(get_ichrone("synthetic", device="cpu", **_SMALL), _SMALL_TRUTH))
    x = p.clone().requires_grad_(True)
    star_lnlike_grad_cuda.launches = 0
    (g,) = torch.autograd.grad(model.lnpost_batch(x).sum(), x)
    assert star_lnlike_grad_cuda.launches == 1
    saved = star_mod.star_lnlike_fused
    star_mod.star_lnlike_fused = star_lnlike_fused_plain
    try:
        x2 = p.clone().requires_grad_(True)
        (g2,) = torch.autograd.grad(model.lnpost_batch(x2).sum(), x2)
    finally:
        star_mod.star_lnlike_fused = saved
    check_grad("posterior gradient, kernel vs plain path", g.cpu().numpy(), g2.cpu().numpy(), 1e-9)

    mod = _tree_model(dev, "star3")
    xt = torch.as_tensor(_tree_pts(mod, 512, seed=1), device=dev, dtype=torch.float64).requires_grad_(True)
    tree_lnlike_grad_cuda.launches = 0
    torch.autograd.grad(mod.lnpost_batch(xt).sum(), xt)
    assert tree_lnlike_grad_cuda.launches == 1

    y = torch.zeros(8, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="has no backward kernel"):
        cluster_lnmarginal_cuda(y, *([None] * 13))
    with pytest.raises(RuntimeError, match="has no backward kernel"):
        catalog_lnlike_cuda(y, None)


@pytest.mark.parametrize("kind", ["binary", "tree", "isotrack"])
def test_posterior_gradient_on_card_matches_cpu(dev, kind, request):
    """Autograd through ``lnpost_batch`` on the card (kernels A and A′, or C
    and C′; ``IsoTrackModel``'s two launches take A′ with no code of their
    own) against autograd on the CPU (the plain versions), float64, at
    adversarial points: |Δ| <= 1e-9 of the row's scale, identical NaN and
    inf patterns (``chip_smoke.check_grad``), one backward launch a
    likelihood call."""
    from chip_smoke import check_grad
    from isochrones_torch.ops.star_cuda import star_lnlike_grad_cuda
    from isochrones_torch.ops.tree_cuda import tree_lnlike_grad_cuda

    if kind == "isotrack":
        gpu, cpu = _isotrack(dev, "synthetic", request), _isotrack("cpu", "synthetic", request)
        pts, counter, per_call = isotrack_points(cpu, 2048, seed=7), star_lnlike_grad_cuda, 2
    elif kind == "tree":
        gpu, cpu = _tree_model(dev, "star3"), _tree_model("cpu", "star3")
        pts, counter, per_call = _tree_pts(cpu, 2048, seed=7), tree_lnlike_grad_cuda, 1
    else:
        obs = star_observations(get_ichrone("synthetic", device="cpu", **_SMALL), _SMALL_TRUTH)
        gpu, cpu = (BinaryStarModel(get_ichrone("synthetic", device=d, **_SMALL), **obs) for d in (dev, "cpu"))
        pts, counter, per_call = star_points(cpu.ic.model.knots, 2, 2048, seed=7), star_lnlike_grad_cuda, 1

    def grad(model, device):
        x = torch.as_tensor(pts, device=device, dtype=torch.float64).requires_grad_(True)
        (g,) = torch.autograd.grad(model.lnpost_batch(x).sum(), x)
        return g.cpu().numpy()

    before = counter.launches
    got = grad(gpu, dev)
    assert counter.launches == before + per_call
    check_grad(f"posterior gradient {kind}", got, grad(cpu, "cpu"), 1e-9)


# ---- kernel B (interp_nd) and B'

#: axis kinds of compute_axis_maps and a knot count each: "compare" at 4
#: knots counts them, at 12 searches; "search" has no map (the shims' and
#: the searchsorted path)
_INTERP_AXES = {"exact_affine": 9, "affine": 7, "log": 11, "compare": 12, "compare4": 4, "search": 13}
_INTERP_CASES = [("exact_affine",), ("compare4",), ("search",), ("affine", "log"), ("compare", "search"),
                 ("exact_affine", "affine", "compare"), ("log", "compare4", "search"),
                 ("affine", "exact_affine", "log", "compare"), ("search", "search", "compare4", "exact_affine"),
                 ("exact_affine", "compare4", "affine", "search", "log"),
                 ("compare4", "exact_affine", "affine", "log", "compare", "search")]


def _interp_grid(kinds, n_cols, seed, nan_frac=0.03):
    """A seeded dense grid ``(values, knots, axis_maps)`` in numpy, one axis
    of each kind (the maps checked against ``compute_axis_maps``), values
    NaN-padded at random rows and, at half that rate, single entries."""
    from isochrones_torch.ops.interp import compute_axis_maps

    rng = np.random.default_rng(seed)
    knots = []
    for kind in kinds:
        n = _INTERP_AXES[kind]
        if kind == "exact_affine":
            k = -2.0 + 0.25 * np.arange(n)
        elif kind == "affine":
            k = np.linspace(0.3, 1.7, n)
        elif kind == "log":
            k = np.geomspace(0.1, 10.0, n)
        else:
            k = np.cumsum(rng.uniform(0.2, 1.0, n)) - 3.0
        knots.append(k)
    maps = compute_axis_maps(knots)
    for kind, m in zip(kinds, maps):
        want = {"compare4": "compare", "search": "compare"}.get(kind, kind)
        assert m is not None and m[0] == want, (kinds, maps)
    maps = tuple(None if kind == "search" else m for kind, m in zip(kinds, maps))
    shape = tuple(len(k) for k in knots)
    values = rng.normal(0.0, 1.0, shape + (n_cols,)) * 10.0 ** rng.integers(-2, 4, n_cols)
    values[rng.random(shape) < nan_frac] = np.nan
    values[rng.random(values.shape) < nan_frac / 2] = np.nan
    return values, knots, maps


def _interp_on(values, knots, dev, dtype):
    return (torch.as_tensor(values, device=dev, dtype=dtype),
            tuple(torch.as_tensor(k, device=dev, dtype=dtype) for k in knots))


@pytest.mark.parametrize("icols", [None, (0,), (2, 0), tuple(range(11)) + (3,)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kinds", _INTERP_CASES, ids=lambda k: "-".join(k))
def test_interp_kernel_matches_plain(dev, kinds, dtype, icols):
    """Kernel B against the plain version on the card: every axis kind, 1-6
    axes (the cap), NaN-padded corners, exact interior, bottom and top knots,
    out-of-bounds points and NaN coordinates, column subsets (one, out of
    order, more than one chunk of 8), batches that leave a partial warp;
    identical NaN patterns, the tolerances of ``chip_smoke.check_interp``."""
    from chip_smoke import ATOL_INTERP_F32, ATOL_INTERP_F64, RTOL_INTERP_F64, check_interp, interp_points, interp_scale
    from isochrones_torch.ops.interp import interp_nd, interp_nd_plain
    from isochrones_torch.ops.interp_cuda import interp_nd_cuda

    values, knots, maps = _interp_grid(kinds, 12, seed=len(kinds))
    v, k = _interp_on(values, knots, dev, dtype)
    pts = torch.as_tensor(interp_points(knots, 4133, seed=3), device=dev, dtype=dtype)
    before = interp_nd_cuda.launches
    got = interp_nd(v, k, pts, icols=icols, axis_maps=maps)
    torch.cuda.synchronize()
    assert interp_nd_cuda.launches == before + 1
    ref = interp_nd_plain(v, k, pts, icols=icols, axis_maps=maps)
    assert got.dtype == dtype and got.shape == ref.shape
    f64 = dtype == torch.float64
    check_interp(f"interp {kinds} {dtype}", got, ref, interp_scale(values, icols),
                 RTOL_INTERP_F64 if f64 else 0.0, ATOL_INTERP_F64 if f64 else ATOL_INTERP_F32)
    assert torch.isnan(ref).any() and torch.isfinite(ref).any()
    # the points' leading shape is kept
    got3 = interp_nd(v, k, pts[:4128].reshape(2, 2064, len(kinds)), icols=icols, axis_maps=maps)
    assert torch.equal(torch.isnan(got3.reshape(4128, -1)), torch.isnan(got[:4128]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_interp_kernel_on_model_and_bc_grids(dev, dtype):
    """Kernel B on the synthetic grids' own tables and maps (affine age,
    exact-affine feh and EEP; the BC grid's compare Teff): the ladder's two
    mass columns, ``interp_mag``'s 4-d BC call, every model column."""
    from chip_smoke import ATOL_INTERP_F32, ATOL_INTERP_F64, RTOL_INTERP_F64, check_interp, interp_points, interp_scale
    from isochrones_torch.ops.interp import interp_nd_plain
    from isochrones_torch.ops.interp_cuda import interp_nd_cuda

    ic = get_ichrone("synthetic", device=dev, dtype=dtype, **_SMALL)
    f64 = dtype == torch.float64
    tol = (RTOL_INTERP_F64, ATOL_INTERP_F64) if f64 else (0.0, ATOL_INTERP_F32)
    ci = ic.model.column_index
    for g, icols in ((ic.model, (ci["initial_mass"], ci["dm_deep"])), (ic.model, None),
                     (ic.bc, tuple(ic.bc.column_index[b] for b in ("J", "H", "K")))):
        pts = torch.as_tensor(interp_points(g.knots, 20000, seed=5), device=dev, dtype=dtype)
        got = interp_nd_cuda(g.values, g.knots, pts, icols=icols, axis_maps=g.axis_maps)
        ref = interp_nd_plain(g.values, g.knots, pts, icols=icols, axis_maps=g.axis_maps)
        check_interp(f"grid {len(g.knots)}-d {icols}", got, ref, interp_scale(g.values, icols), *tol)


def test_interp_shims_and_interpolator_launch_kernel(dev):
    """The reference-named shims (no maps: searchsorted on irregular axes),
    ``GridInterpolator.__call__``, ``interp_value``/``interp_mag`` and the
    interpolator's ``__call__`` launch kernel B and equal the CPU."""
    from isochrones_torch import interp as shims
    from isochrones_torch.ops.interp_cuda import interp_nd_cuda

    from isochrones_torch.ops.interp import compute_axis_maps

    rng = np.random.default_rng(2)
    knots = [np.cumsum(rng.uniform(0.1, 1.0, 300)), np.array([-1.0, 2.0]), np.array([0.0, 0.5, 3.0])]
    assert compute_axis_maps(knots)[:2] == (None, None)  # more than 256 irregular knots; two knots
    values = rng.normal(size=(300, 2, 3, 5))
    xs = [np.linspace(k[0], k[-1], 17) for k in knots]
    before = interp_nd_cuda.launches
    got = shims.interp_values_3d(*xs, values, [0, 3], *knots, device=dev)
    assert interp_nd_cuda.launches == before + 1
    np.testing.assert_allclose(got, shims.interp_values_3d(*xs, values, [0, 3], *knots, device="cpu"), rtol=1e-12)
    ic, icc = (get_ichrone("synthetic", device=d, **_SMALL) for d in (dev, "cpu"))
    pars = [np.linspace(30, 90, 50), 9.0, 0.0, 200.0, 0.1]
    before = interp_nd_cuda.launches
    out, ref = ic(*pars), icc(*pars)
    assert interp_nd_cuda.launches == before + 3  # every column, then the model and BC lerps of interp_mag
    for c in ref:
        np.testing.assert_allclose(out[c], ref[c], rtol=1e-10, atol=1e-12, err_msg=c)


def test_interp_kernel_refuses(dev):
    """The wrapper raises on mixed dtypes (no caller mixes them), past the
    caps (6 axes, 128 columns), on a table that does not match its knots,
    and where the table asks for a gradient."""
    from isochrones_torch.ops.interp_cuda import MAX_COLS, MAX_DIM, interp_nd_cuda

    values, knots, maps = _interp_grid(("affine", "log"), 3, seed=0)
    v, k = _interp_on(values, knots, dev, torch.float64)
    pts = torch.zeros((4, 2), device=dev, dtype=torch.float64)
    with pytest.raises(ValueError, match="one dtype"):
        interp_nd_cuda(v, k, pts.float(), axis_maps=maps)
    with pytest.raises(ValueError, match="one dtype"):
        interp_nd_cuda(v.float(), k, pts, axis_maps=maps)
    seven = tuple(torch.arange(2.0, device=dev, dtype=torch.float64) for _ in range(MAX_DIM + 1))
    with pytest.raises(ValueError, match=f"1 to {MAX_DIM} axes"):
        interp_nd_cuda(torch.zeros((2,) * (MAX_DIM + 1) + (1,), device=dev, dtype=torch.float64), seven,
                       torch.zeros((3, MAX_DIM + 1), device=dev, dtype=torch.float64))
    with pytest.raises(ValueError, match=f"at most {MAX_COLS} columns"):
        interp_nd_cuda(v, k, pts, icols=(0,) * (MAX_COLS + 1), axis_maps=maps)
    with pytest.raises(ValueError, match="does not match"):
        interp_nd_cuda(v[:, :-1], k, pts, axis_maps=maps)
    with pytest.raises(RuntimeError, match="has no backward kernel"):
        interp_nd_cuda(v.clone().requires_grad_(True), k, pts, axis_maps=maps)


@pytest.mark.parametrize("P", [4, 8, 3001])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("icols", [(1,), (2, 0), tuple(range(12))])
@pytest.mark.parametrize("kinds", _INTERP_CASES[3:], ids=lambda k: "-".join(k))
def test_interp_grad_kernel_matches_autograd(dev, kinds, icols, dtype, P):
    """Kernel B' (through ``InterpNd``) against torch autograd of the plain
    version with a seeded cotangent: float64 to 1e-9 of the row's scale,
    float32 against the plain float32 version to ``RTOL_GRAD_F32``;
    identical NaN patterns (none: a bad point and a NaN value pass 0); one
    backward launch. At the NUTS chains' 4 and 8 points (a group of lanes a
    point) and at 3001; 12 columns take two chunks from one cell search."""
    from chip_smoke import RTOL_GRAD_F32, RTOL_GRAD_F64, check_grad, interp_points
    from isochrones_torch.ops.interp import interp_nd, interp_nd_plain
    from isochrones_torch.ops.interp_cuda import interp_nd_grad_cuda

    values, knots, maps = _interp_grid(kinds, 12, seed=11)
    v, k = _interp_on(values, knots, dev, dtype)
    pts = torch.as_tensor(interp_points(knots, P, seed=4), device=dev, dtype=dtype)
    cot = torch.as_tensor(np.random.default_rng(1).normal(size=(P, len(icols))), device=dev, dtype=dtype)

    def grad(fn):
        x = pts.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(v, k, x, icols=icols, axis_maps=maps), x, grad_outputs=cot)
        return g.cpu().numpy()

    before = interp_nd_grad_cuda.launches
    got = grad(interp_nd)
    assert interp_nd_grad_cuda.launches == before + 1
    check_grad(f"interp grad {kinds} {dtype} P={P}", got, grad(interp_nd_plain),
               RTOL_GRAD_F64 if dtype == torch.float64 else RTOL_GRAD_F32)
    assert np.isfinite(got).all()
    if P > 8:  # a few adversarial points may all be off the grid or beside a NaN row
        assert (got != 0).any()


#: (grid, points, lanes a point): 8 lanes a point on 3 axes and 16 on 4
#: while P * G stays within 2^18 threads, halving to 1 at large batches
_INTERP_GRAD_WIDTHS = [("model", 4, 8), ("model", 8, 8), ("model", 32768, 8), ("model", 40000, 4),
                       ("model", 100000, 2), ("model", 140000, 1), ("bc", 4, 16), ("bc", 8, 16),
                       ("bc", 16384, 16), ("bc", 20000, 8), ("bc", 40000, 4), ("bc", 131072, 2),
                       ("bc", 140000, 1)]


@pytest.mark.parametrize("which,P,lanes", _INTERP_GRAD_WIDTHS)
def test_interp_grad_kernel_group_widths(dev, which, P, lanes):
    """B' on the small synthetic model grid (3 axes, ``nu_max`` and
    ``delta_nu``, as the seismic terms call it) and on its 4-axis BC grid
    (every one of its 11 columns: two chunks from one cell search) at
    adversarial points: the group width its rule gives (the library's own
    choice, ``interp_cuda.grad_lanes``), and autograd of the plain version,
    float64 and float32."""
    from chip_smoke import RTOL_GRAD_F32, RTOL_GRAD_F64, check_grad, interp_points
    from isochrones_torch.ops.interp import interp_nd_plain
    from isochrones_torch.ops.interp_cuda import grad_lanes, interp_nd_grad_cuda

    ic = get_ichrone("synthetic", device=dev, **_SMALL)
    grid = ic.model if which == "model" else ic.bc
    assert grad_lanes(P, len(grid.knots)) == lanes
    icols = (grid.column_index["nu_max"], grid.column_index["delta_nu"]) if which == "model" else None
    n_cols = 2 if which == "model" else len(grid.columns)
    pts64 = torch.as_tensor(interp_points(grid.knots, P, seed=P % 97), device=dev, dtype=torch.float64)
    cot64 = torch.as_tensor(np.random.default_rng(P).normal(size=(P, n_cols)), device=dev, dtype=torch.float64)
    for dtype in (torch.float64, torch.float32):
        g = grid if dtype == torch.float64 else grid_as(grid, dtype)
        pts, cot = pts64.to(dtype), cot64.to(dtype)
        call = lambda: interp_nd_grad_cuda(g.values, g.knots, pts, cot, icols, g.axis_maps)  # noqa: E731
        with torch.enable_grad():
            x = pts.clone().requires_grad_(True)
            (ref,) = torch.autograd.grad(interp_nd_plain(g.values, g.knots, x, icols=icols, axis_maps=g.axis_maps),
                                         x, grad_outputs=cot)
        check_grad(f"B' {which} P={P} {dtype}", call().cpu().numpy(), ref.cpu().numpy(),
                   RTOL_GRAD_F64 if dtype == torch.float64 else RTOL_GRAD_F32)


@pytest.mark.parametrize("which,P", [("model", 4), ("model", 8), ("model", 131072), ("bc", 8), ("bc", 20000)])
def test_interp_grad_kernel_two_launches_bitwise_equal(dev, which, P):
    """B' has no atomics: two launches give the same bits, and a point's
    gradient does not depend on the points beside it."""
    from chip_smoke import interp_points
    from isochrones_torch.ops.interp_cuda import interp_nd_grad_cuda

    ic = get_ichrone("synthetic", device=dev, **_SMALL)
    grid = ic.model if which == "model" else ic.bc
    icols = (grid.column_index["nu_max"], grid.column_index["delta_nu"]) if which == "model" else None
    n_cols = 2 if which == "model" else len(grid.columns)
    for dtype in (torch.float64, torch.float32):
        g = grid if dtype == torch.float64 else grid_as(grid, dtype)
        pts = torch.as_tensor(interp_points(grid.knots, P, seed=3), device=dev, dtype=dtype)
        cot = torch.as_tensor(np.random.default_rng(5).normal(size=(P, n_cols)), device=dev, dtype=dtype)
        first = interp_nd_grad_cuda(g.values, g.knots, pts, cot, icols, g.axis_maps).clone()
        second = interp_nd_grad_cuda(g.values, g.knots, pts, cot, icols, g.axis_maps)
        flipped = interp_nd_grad_cuda(g.values, g.knots, pts.flip(0).contiguous(), cot.flip(0).contiguous(), icols,
                                      g.axis_maps).flip(0)
        bits = torch.int64 if dtype == torch.float64 else torch.int32
        assert torch.equal(first.view(bits), second.view(bits))
        assert torch.equal(first, flipped)


def _check_interp_both_layouts(dev, values, knots, maps, icols, pts, dtype, name):
    """Kernel B from the row layout and from a planar copy of ``icols``
    against the plain version (``chip_smoke.check_interp``), one launch each."""
    from chip_smoke import ATOL_INTERP_F32, ATOL_INTERP_F64, RTOL_INTERP_F64, check_interp, interp_scale
    from isochrones_torch.ops.interp import interp_nd, interp_nd_plain
    from isochrones_torch.ops.interp_cuda import interp_nd_cuda

    v, k = _interp_on(values, knots, dev, dtype)
    p = pts if isinstance(pts, torch.Tensor) else torch.as_tensor(pts, device=dev, dtype=dtype)
    ref = interp_nd_plain(v, k, p, icols=icols, axis_maps=maps)
    f64 = dtype == torch.float64
    tol = (RTOL_INTERP_F64, ATOL_INTERP_F64) if f64 else (0.0, ATOL_INTERP_F32)
    for layout in ("row", "planar"):
        before = interp_nd_cuda.launches
        got = interp_nd(v, k, p, icols=icols, axis_maps=maps, planar=layout == "planar")
        torch.cuda.synchronize()
        assert interp_nd_cuda.launches == before + 1
        assert got.dtype == dtype and got.shape == ref.shape
        check_interp(f"{name} {layout} {dtype}", got, ref, interp_scale(values, icols), *tol)
    return ref


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ncols", [1, 2, 3, 4, 8, 9, 15, 128])
def test_interp_kernel_column_instances(dev, ncols, dtype):
    """Every column instance of kernel B (exactly 1-4 columns, chunks of 8
    for 8, 9, 15 and 128) from the row layout and from a planar copy, on a
    3-d and a 4-d grid of mixed axis kinds: NaN-padded corners, exact, top
    and bottom knots, out of bounds and NaN points, a ragged last block."""
    from isochrones_torch.ops.interp_cuda import CHUNK, launch_choice

    for kinds in (("affine", "exact_affine", "compare"), ("log", "compare4", "search", "exact_affine")):
        values, knots, maps = _interp_grid(kinds, 131, seed=ncols)
        icols = tuple(int(c) for c in np.random.default_rng(ncols).permutation(131)[:ncols])
        assert launch_choice(values.size, ncols, len(kinds))[0] == (ncols if ncols <= 4 else CHUNK)
        ref = _check_interp_both_layouts(dev, values, knots, maps, icols, interp_points_of(knots, 4133, ncols), dtype,
                                         f"{ncols} columns {kinds}")
        assert torch.isnan(ref).any() and torch.isfinite(ref).any()


@pytest.mark.parametrize("icols", [(0,), (2, 0), (1, 2, 0), (3, 1, 2, 0), None])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kinds", _INTERP_CASES, ids=lambda k: "-".join(k))
def test_interp_kernel_planar_every_kind(dev, kinds, dtype, icols):
    """Kernel B from a planar copy and from the row layout on every axis kind
    and 1-6 axes (the exact instances up to 4 axes, chunks past them)."""
    values, knots, maps = _interp_grid(kinds, 12, seed=len(kinds) + 7)
    _check_interp_both_layouts(dev, values, knots, maps, icols, interp_points_of(knots, 2081, 13), dtype,
                               f"planar {kinds}")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kinds", _INTERP_CASES, ids=lambda k: "-".join(k))
def test_interp_kernel_wide_offsets(dev, kinds, dtype, monkeypatch):
    """The 64-bit offset instances (chunks of 8), forced through the
    wrapper's choice, from both layouts, at 1, 2, 3 and 12 columns."""
    from isochrones_torch.ops import interp_cuda

    monkeypatch.setattr(interp_cuda, "WIDE_ELEMENTS", 0)
    assert interp_cuda.launch_choice(10, 2, 3) == (interp_cuda.CHUNK, True)
    values, knots, maps = _interp_grid(kinds, 12, seed=len(kinds) + 3)
    for icols in ((5,), (2, 0), (1, 2, 0), None):
        _check_interp_both_layouts(dev, values, knots, maps, icols, interp_points_of(knots, 1501, 6), dtype,
                                   f"wide {kinds} {icols}")


@pytest.mark.parametrize("P", [1, 31, 127, 128, 129, 4097])
@pytest.mark.parametrize("ncols", [1, 2, 3, 4, 9])
def test_interp_kernel_ragged_blocks_and_unaligned_points(dev, P, ncols):
    """Batches whose last block is ragged (lanes past the batch read and
    write nothing, yet reach the cell searches' warp votes), and points one
    value into their storage (off 16-byte alignment)."""
    kinds = ("affine", "exact_affine", "compare")
    values, knots, maps = _interp_grid(kinds, 12, seed=P)
    icols = tuple(range(ncols))
    pts = interp_points_of(knots, P, P)
    for dtype in (torch.float64, torch.float32):
        _check_interp_both_layouts(dev, values, knots, maps, icols, pts, dtype, f"P={P}")
        store = torch.empty(P * 3 + 1, device=dev, dtype=dtype)
        store[1:] = torch.as_tensor(pts, device=dev, dtype=dtype).reshape(-1)
        shifted = store[1:].view(P, 3)
        assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
        _check_interp_both_layouts(dev, values, knots, maps, icols, shifted, dtype, f"P={P} unaligned")


def interp_points_of(knots, n, seed):
    from chip_smoke import interp_points

    return interp_points(knots, n, seed=seed)


def test_cluster_ladder_reads_planar_copies_on_card(dev, monkeypatch):
    """The cluster ladder's mass call and its property call (Teff) read
    column-planar copies on the card, built once per table and column tuple,
    and ``lnpost_batch`` equals the CPU's (float64, rtol 1e-9)."""
    from isochrones_torch.ops import interp_cuda

    data = read_csv(FIXTURE)
    data["Teff"] = np.full(len(data["J_mag"]), 6000.0)
    data["Teff_unc"] = np.full(len(data["J_mag"]), 300.0)
    kw = dict(bands=("J", "H", "K"), props=("parallax", "Teff"), eep_bounds=(1, 1400), eep_step=20.0,
              max_distance=3000, minq=0.2, mass_bounds=(0.6, 2.0))
    grid = dict(n_feh=5, n_mass=40, n_eep=1710, n_age=20)
    gpu = StarClusterModel(get_ichrone("synthetic", device=dev, **grid), data, **kw)
    cpu = StarClusterModel(get_ichrone("synthetic", device="cpu", **grid), data, **kw)
    seen, real = [], interp_cuda._forward

    def spy(values, knots, points, icols, axis_maps, planar=False):
        seen.append((planar, tuple(icols)))
        return real(values, knots, points, icols, axis_maps, planar)

    monkeypatch.setattr(interp_cuda, "_forward", spy)
    p = np.array([9.0, 0.0, 300.0, 0.05, -2.0, 0.3, 0.3]) + np.random.default_rng(0).normal(
        0, [0.05, 0.05, 5.0, 0.01, 0.1, 0.03, 0.03], size=(12, 7))
    got = gpu.lnpost_batch(p).cpu().numpy()
    ci = gpu.ic.model.column_index
    want = [(ci["initial_mass"], ci["dm_deep"]), (ci["Teff"],)]
    assert [icols for planar, icols in seen if planar] == want
    copies = dict(interp_cuda._PLANAR[gpu.ic.model.values])
    assert set(copies) == set(want) and all(copies[c] is not None for c in want)
    gpu.lnpost_batch(p)
    assert all(interp_cuda._PLANAR[gpu.ic.model.values][c] is copies[c] for c in want)
    check_close("ladder on planar copies", got, cpu.lnpost_batch(p).numpy(), 1e-9)


#: the box about _SMALL_TRUTH: EEPs, age, feh, distance, AV
_SMALL_BOX = ((40, 80), (30, 60), (8.8, 9.2), (-0.2, 0.2), (150, 250), (0.0, 0.3))


def test_seismic_posterior_gradient_on_card(dev):
    """A binary with ``nu_max`` and ``delta_nu`` observed: ``lnpost_batch``
    and its gradient on the card (kernels A, A', B, B') against the CPU,
    float64, rtol 1e-10 and 1e-9 of the row's scale."""
    from chip_smoke import check_grad
    from isochrones_torch.ops.interp_cuda import interp_nd_cuda, interp_nd_grad_cuda

    icc = get_ichrone("synthetic", device="cpu", **_SMALL)
    obs = star_observations(icc, _SMALL_TRUTH)
    obs.update(nu_max=(float(icc.nu_max(60.0, 9.0, 0.0)), 5.0), delta_nu=(float(icc.delta_nu(60.0, 9.0, 0.0)), 1.0))
    gpu, cpu = (BinaryStarModel(get_ichrone("synthetic", device=d, **_SMALL), **obs) for d in (dev, "cpu"))
    pts = star_points(cpu.ic.model.knots, 2, 2048, seed=7)
    pts[1024:] = star_points(cpu.ic.model.knots, 2, 1024, seed=8, box=_SMALL_BOX)

    def run(model, device):
        x = torch.as_tensor(pts, device=device, dtype=torch.float64).requires_grad_(True)
        lp = model.lnpost_batch(x)
        (g,) = torch.autograd.grad(lp.sum(), x)
        return lp.detach().cpu().numpy(), g.cpu().numpy()

    b, bg = interp_nd_cuda.launches, interp_nd_grad_cuda.launches
    lp, g = run(gpu, dev)
    assert interp_nd_cuda.launches > b and interp_nd_grad_cuda.launches > bg
    lp_ref, g_ref = run(cpu, "cpu")
    check_star("seismic lnpost", [lp], [lp_ref], 1e-10)
    check_grad("seismic gradient", g, g_ref, 1e-9)
