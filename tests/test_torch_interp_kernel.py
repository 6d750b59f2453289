"""Kernel B's dispatch on the CPU, and the paths that run it on the card
held to the JAX package on the CPU.

- ``ops.interp.interp_nd`` sends CPU points to ``interp_nd_plain`` (the
  kernel's counter stays 0, the results are bitwise the plain version's) and
  raises on any other device type; ``ops.mags.interp_mag`` likewise.
- The plain versions of kernels A (star), C (tree), E (catalog) and F (the
  forward model, the plain EEP root finder included) compute through
  ``interp_nd_plain``: with the dispatcher, the kernel wrapper and every
  module's name for them made to raise, they return what they returned.
- The cluster ladder (``StarClusterModel._build_block_lnmarg``: the mass
  columns, ``interp_mag``, the property columns) and a seismic binary's
  ``lnpost_batch`` and gradient (``nu_max``/``delta_nu`` through
  ``interp_nd``) against the JAX package (``jax.grad``), float64, small
  synthetic grid: rtol 1e-10 (the gradient to 1e-10 of the row's scale,
  ``max(1, max |grad|)``), identical NaN and -inf patterns.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isochrones_torch
from chip_smoke import catalog_table, star_points, tree_points
from isochrones_tpu import get_ichrone as jax_get_ichrone
from isochrones_tpu import starmodel as jsm
from isochrones_tpu.cluster import SimulatedCluster
from isochrones_tpu.cluster import StarClusterModel as JaxStarClusterModel
from isochrones_torch import get_ichrone
from isochrones_torch import starmodel as tsm
from isochrones_torch.ops import catalog as cat_ops
from isochrones_torch.ops import eep as eep_ops
from isochrones_torch.ops import generate as gen_ops
from isochrones_torch.ops import interp as interp_ops
from isochrones_torch.ops import interp_cuda
from isochrones_torch.ops import mags as mags_ops
from isochrones_torch.ops import star as star_ops
from isochrones_torch.ops import tree as tree_ops

_DIMS = dict(n_feh=7, n_mass=30, n_eep=100, n_age=30)
_TRUTH = [60.0, 9.0, 0.0, 200.0, 0.1]
RTOL = 1e-10


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ics():
    return get_ichrone("synthetic", device="cpu", **_DIMS), jax_get_ichrone("synthetic", **_DIMS)


def _refuse(*_args, **_kwargs):
    raise AssertionError("the kernel branch was reached")


def _assert_same(got, ref, rtol=RTOL):
    got, ref = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
    assert got.shape == ref.shape
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.array_equal(np.isneginf(got), np.isneginf(ref))
    assert np.array_equal(np.isposinf(got), np.isposinf(ref))
    m = np.isfinite(ref)
    np.testing.assert_allclose(got[m], ref[m], rtol=rtol, atol=0)
    return m


def test_dispatcher_takes_plain_version_on_cpu(ics, monkeypatch):
    tic, _ = ics
    g = tic.model
    pts = torch.as_tensor(star_points(g.knots, 1, 512, seed=1)[:, [1, 2, 0]])
    interp_cuda.interp_nd_cuda.launches = interp_cuda.interp_nd_grad_cuda.launches = 0
    got = interp_ops.interp_nd(g.values, g.knots, pts, icols=(3, 0), axis_maps=g.axis_maps)
    ref = interp_ops.interp_nd_plain(g.values, g.knots, pts, icols=(3, 0), axis_maps=g.axis_maps)
    assert torch.equal(torch.isnan(got), torch.isnan(ref)) and torch.isnan(ref).any()
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(ref))
    x = pts.clone().requires_grad_(True)
    interp_ops.interp_nd(g.values, g.knots, x, icols=(3,), axis_maps=g.axis_maps).nansum().backward()
    assert interp_cuda.interp_nd_cuda.launches == 0 and interp_cuda.interp_nd_grad_cuda.launches == 0
    assert torch.isfinite(x.grad).all()

    mags = mags_ops.interp_mag(torch.as_tensor([_TRUTH]), tic._param_index_order, tic.model_packed,
                               tic._packed_icols, tic.bc, (0, 2))
    plain = mags_ops.interp_mag_plain(torch.as_tensor([_TRUTH]), tic._param_index_order, tic.model_packed,
                                      tic._packed_icols, tic.bc, (0, 2))
    for a, b in zip(mags, plain):
        assert torch.equal(a, b)

    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        interp_ops.interp_nd(g.values, g.knots, meta)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        interp_cuda.interp_nd_cuda(g.values, g.knots, pts)
    assert interp_cuda.interp_nd_cuda.launches == 0


def _plain_calls(tic, workdir):
    """The plain versions of kernels A, C, E and F on seeded points, as
    calls with their inputs built."""
    import os
    import shutil

    from isochrones_torch.batch import BatchStarFitter
    from isochrones_torch.treemodel import StarModel

    bin_model = tsm.BinaryStarModel(tic, Teff=(5500.0, 100.0), J=(9.0, 0.02), K=(8.5, 0.02), parallax=(5.0, 0.05))
    pars = torch.as_tensor(star_points(tic.model.knots, 2, 256, seed=2))
    star_lk = bin_model._star_likelihood()
    folder = workdir / "star3"
    shutil.copytree(os.path.join(os.path.dirname(os.path.abspath(__file__)), "star3"), folder)
    tree = StarModel.from_ini(tic, str(folder))
    tp = torch.as_tensor(tree_points(tree.param_names, [k.numpy() for k in tic.model.knots], 128, seed=3))
    tree_lk = tree._get_fn("lnlike").likelihood
    truths, table = catalog_table(tic, 24, (30.0, 80.0), seed=4)
    cat_lk = BatchStarFitter(tic, table)._catalog_likelihood()
    cp = torch.as_tensor(np.repeat(np.asarray(truths)[:, None, :], 16, axis=1)
                         + np.random.default_rng(5).normal(0, 0.05, (len(truths), 16, 5)))
    fm = get_ichrone("synthetic", tracks=True, device="cpu", n_feh=5, n_mass=20, n_eep=60, n_age=20)._forward_model
    rng = np.random.default_rng(6)
    n = 200
    gen = [torch.as_tensor(x) for x in (rng.uniform(0.5, 2.0, n), rng.uniform(8.5, 9.8, n), rng.uniform(-1.0, 0.3, n),
                                        np.full(n, 200.0), np.full(n, 0.1))]
    return {
        "star": lambda: star_ops.star_lnlike_fused_plain(pars, star_lk),
        "tree": lambda: tree_ops.tree_lnlike_fused_plain(tp, tree_lk),
        "catalog": lambda: cat_ops.catalog_lnlike_plain(cp, cat_lk),
        "generate": lambda: gen_ops.generate_plain(fm, *gen, (3, 5), (0, 1), all_As=True, accurate=True),
    }


def test_plain_versions_never_reach_the_kernel(ics, monkeypatch, tmp_path):
    """Kernels A, C, E and F's plain versions (and the plain EEP root finder
    they run) compute through ``interp_nd_plain``."""
    tic, _ = ics
    calls = _plain_calls(tic, tmp_path)
    ref = {name: call() for name, call in calls.items()}
    monkeypatch.setattr(interp_cuda, "interp_nd_cuda", _refuse)
    monkeypatch.setattr(interp_cuda, "interp_nd_grad_cuda", _refuse)
    monkeypatch.setattr(interp_ops, "interp_nd", _refuse)
    monkeypatch.setattr(mags_ops, "interp_nd", _refuse)
    monkeypatch.setattr(mags_ops, "interp_mag", _refuse)
    for mod in (star_ops, tree_ops, cat_ops, gen_ops, eep_ops):
        monkeypatch.setattr(mod, "interp_nd", _refuse, raising=False)
        monkeypatch.setattr(mod, "interp_mag", _refuse, raising=False)
    for name, call in calls.items():
        for g, r in zip(call(), ref[name]):
            if r is None:
                continue
            assert torch.equal(torch.isnan(g), torch.isnan(r)) and torch.isfinite(r).any(), name
            assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(r)), name


# ---- the cluster ladder against the JAX package

_CLUSTER_TRUTH = np.array([9.0, 0.0, 500.0, 0.05, -2.0, 0.3, 0.3])
_CLUSTER_KW = dict(eep_bounds=(1, 95), max_distance=2000, minq=0.2, max_AV=0.2)


def test_cluster_ladder_matches_jax():
    """``_build_block_lnmarg`` (per-star marginals of a walker batch) on the
    port against the JAX package's per walker, at the truth and 32 points of
    the prior box, rtol 1e-10, identical NaN and -inf patterns."""
    jic = jax_get_ichrone("synthetic", **_DIMS)
    sim = SimulatedCluster(12, age=9.0, feh=0.0, distance=500.0, AV=0.05, alpha=-2.0, gamma=0.3, fB=0.3,
                           bands=("J", "H", "K"), mass_range=(0.5, 3.0), distance_scatter=2.0, ic=jic, rng=42,
                           phot_unc=0.02)
    tic = isochrones_torch.get_ichrone("synthetic", device="cpu", **_DIMS)
    data = {c: sim.df[c].values for c in sim.df.columns}
    rng = np.random.default_rng(3)
    teff = dict(Teff=rng.normal(5500.0, 400.0, len(sim.df)), Teff_unc=np.full(len(sim.df), 150.0))
    data.update(teff)
    props = ["parallax", "Teff"]  # a property column makes its own ladder call
    tm = isochrones_torch.StarClusterModel(tic, data, bands=("J", "H", "K"), props=props, **_CLUSTER_KW)
    jm = JaxStarClusterModel(jic, sim.df.assign(**teff), bands=("J", "H", "K"), props=props, **_CLUSTER_KW)
    los, his = tm._bounds_arrays()
    pts = np.vstack([_CLUSTER_TRUTH, los + (his - los) * np.random.default_rng(7).random((32, 7))])
    obs = tm.stars.observation_stacks()
    got = tm._build_block_lnmarg()(torch.as_tensor(pts), *(torch.as_tensor(x) for x in obs)).numpy()
    fj = jax.jit(jm._build_block_lnmarg())
    jobs = tuple(jnp.asarray(x) for x in jm.stars.observation_stacks())
    ref = np.stack([np.asarray(fj(jnp.asarray(p), *jobs)) for p in pts])
    m = _assert_same(got, ref)
    assert m[0].all() and m.sum() >= 100 and np.isneginf(got).any()


# ---- the seismic terms against the JAX package


def _seismic_observations(jic):
    Teff, logg, _, mags = jic.interp_mag(_TRUTH, ["J", "H", "K"])
    nu_max, delta_nu = np.asarray(jic.interp_value(_TRUTH[:3], ["nu_max", "delta_nu"]))
    obs = dict(Teff=(float(Teff), 100.0), logg=(float(logg), 0.1), parallax=(5.0, 0.05),
               nu_max=(float(nu_max) * 1.01, 0.05 * float(nu_max)), delta_nu=(float(delta_nu), 1.0))
    obs.update({b: (float(m), 0.02) for b, m in zip("JHK", np.asarray(mags))})
    return obs


@pytest.mark.parametrize("N", [1, 2])
def test_seismic_lnpost_and_gradient_match_jax(ics, N):
    """A star with ``nu_max``/``delta_nu`` observed (their terms interpolate
    the full model table through ``interp_nd``): ``lnpost_batch`` on
    adversarial and near points, and its gradient (``jax.grad`` of the JAX
    posterior) where lnpost is finite."""
    tic, jic = ics
    obs = _seismic_observations(jic)
    name = {1: "SingleStarModel", 2: "BinaryStarModel"}[N]
    tm, jm = getattr(tsm, name)(tic, **obs), getattr(jsm, name)(jic, **obs)
    assert tm._build_seismic_lnlike() is not None
    rng = np.random.default_rng(N)
    near = np.empty((256, N + 4))
    near[:, :N] = np.sort(rng.uniform(20, 90, (256, N)), axis=1)[:, ::-1]
    near[:, N:] = np.asarray(_TRUTH[1:]) + rng.normal(0, [0.3, 0.2, 20.0, 0.05], (256, 4))
    near[:, N + 3] = np.abs(near[:, N + 3])
    pts = np.concatenate([star_points(tic.model.knots, N, 256, seed=N), near])
    x = torch.tensor(pts, requires_grad=True)
    lp = tm.lnpost_batch(x)
    (g,) = torch.autograd.grad(lp.sum(), x)
    f = jm.lnpost_batch
    jlp = np.asarray(f(jnp.asarray(pts)))
    jg = np.asarray(jax.grad(lambda p: f(p).sum())(jnp.asarray(pts)))
    fin = _assert_same(lp.detach().numpy(), jlp)
    assert fin.sum() >= 100 and (~fin).sum() >= 50
    g = g.numpy()
    assert np.isfinite(g[fin]).all()
    scale = np.maximum(1.0, np.abs(jg[fin]).max(axis=1, keepdims=True))
    err = np.abs(g[fin] - jg[fin]) / scale
    assert err.max() <= RTOL, f"max error {err.max():.3e} of the row's scale"
