"""The port's device mesh (``isochrones_torch.parallel``) on the CPU, held to
the JAX package's 8-device mesh (``tests/conftest.py``) in the same process.

- ``sharded_lnpost`` on an 8-shard CPU mesh against
  ``isochrones_tpu.parallel.sharded_lnpost`` on the 64 points of
  ``tests/test_parallel.py``, rtol 1e-12; ``pad_to_multiple`` and
  ``replicate`` of a synthetic grid equal to the JAX functions';
- sharded against unsharded in the port: the sampler's state and generator
  stay on the mesh's first device and the CPU posteriors' arithmetic for one
  point does not depend on the batch, so the ensemble's ``fit_mcmc``,
  multi-run ``fit_multinest``, ``run_nuts`` on a Gaussian,
  ``run_nested_vmapped`` and the catalog fitter's two fits on 10 and 12
  stars (not divisible by 8) are bitwise the unsharded fits; the single-run
  nested fit within 1e-10; the star's ``fit_nuts`` to rounding (1e-8: on
  the CPU ``torch.log`` rounds a call's body and its tail differently); the
  cluster's ``lnpost_batch`` and ``star_lnmarginals`` within 1e-12 relative
  (the sum over shards adds in another order);
- a mesh of mixed device types, a CUDA mesh without a card, too many CUDA
  devices, an axis the mesh lacks and an object that is not a ``Mesh`` are
  refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import isochrones_torch.parallel as tpar
from isochrones_tpu import get_ichrone as jax_get_ichrone
from isochrones_tpu.batch import BatchStarFitter as JaxBatchStarFitter
from isochrones_tpu.cluster import SimulatedCluster as JaxSimulatedCluster
from isochrones_tpu.cluster import StarClusterModel as JaxStarClusterModel
from isochrones_tpu.parallel import default_mesh as jax_default_mesh
from isochrones_tpu.parallel import mesh_wrap_fn as jax_mesh_wrap_fn
from isochrones_tpu.parallel import pad_to_multiple as jax_pad_to_multiple
from isochrones_tpu.parallel import replicate as jax_replicate
from isochrones_tpu.parallel import shard_batch as jax_shard_batch
from isochrones_tpu.parallel import sharded_lnpost as jax_sharded_lnpost
from isochrones_tpu.starmodel import SingleStarModel as JaxSingleStarModel
from isochrones_torch import SingleStarModel, StarCatalog, get_ichrone
from isochrones_torch.batch import BatchStarFitter
from isochrones_torch.cluster import StarClusterModel
from isochrones_torch.parallel import (
    Mesh, default_mesh, mesh_constrain_leading, mesh_wrap_fn, pad_to_multiple, replicate, shard_batch,
    sharded_lnpost,
)
from isochrones_torch.samplers.nested import run_nested_vmapped

GRID = dict(n_feh=7, n_mass=30, n_eep=100, n_age=30)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the small tensors of these tests run several times
    faster than with a pool of threads beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def isos():
    return jax_get_ichrone("synthetic", **GRID), get_ichrone("synthetic", device="cpu", **GRID)


@pytest.fixture(scope="module")
def models(isos):
    """The star of ``tests/test_parallel.py`` in both packages."""
    jiso, tiso = isos
    Teff, logg, _, mags = jiso.interp_mag([60.0, 9.0, 0.0, 200.0, 0.1], ["J", "H", "K"])
    obs = dict(Teff=(float(Teff), 100.0), logg=(float(logg), 0.1), J=(float(mags[0]), 0.02), parallax=(5.0, 0.05))
    return JaxSingleStarModel(jiso, **obs), SingleStarModel(tiso, **obs)


def _mesh(n, axis="walkers"):
    return default_mesh(n, axis_names=(axis,), device="cpu")


def _points(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return np.array([60.0, 9.0, 0.0, 200.0, 0.1]) + rng.normal(0, [3.0, 0.03, 0.03, 3.0, 0.02], size=(n, 5))


# ------------------------------------------------------------ against JAX
def test_eight_shards_and_the_jax_mesh_shape():
    assert len(jax.devices()) == 8
    mesh = _mesh(8)
    assert mesh.devices == (CPU,) * 8 and mesh.distinct_devices == (CPU,) and mesh.size == 8
    assert mesh.shape == dict(jax_default_mesh(8).shape) == {"walkers": 8}
    two = default_mesh(8, axis_names=("runs", "extra"), device="cpu")
    assert two.shape == dict(jax_default_mesh(8, axis_names=("runs", "extra")).shape)
    assert default_mesh(device="cpu").devices == (CPU,)
    assert Mesh(["cpu", torch.device("cpu", 0)]).devices == _mesh(2).devices


def test_sharded_lnpost_matches_jax(models):
    jm, tm = models
    batch = _points()
    jmesh = jax_default_mesh(8)
    ref = np.asarray(jax_sharded_lnpost(jm.lnpost_batch, jmesh)(jax_shard_batch(jnp.asarray(batch), jmesh)))
    mesh = _mesh(8)
    pieces = shard_batch(torch.as_tensor(batch), mesh)
    assert [len(p) for p in pieces] == [8] * 8
    out = sharded_lnpost(tm.lnpost_batch, mesh)(pieces)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12)
    # the whole batch goes through the same wrapper, and equals the unsharded call
    whole = sharded_lnpost(tm.lnpost_batch, mesh)(torch.as_tensor(batch))
    assert torch.equal(whole, out) and torch.equal(whole, tm.lnpost_batch(batch))


@pytest.mark.parametrize("shape,multiple,axis", [((13, 5), 8, 0), ((16, 5), 8, 0), ((3, 7), 4, 1), ((5,), 1, 0)])
def test_pad_to_multiple_matches_jax(shape, multiple, axis):
    x = np.arange(np.prod(shape), dtype=float).reshape(shape)
    got, n = pad_to_multiple(x, multiple, axis=axis)
    ref, n_ref = jax_pad_to_multiple(x, multiple, axis=axis)
    assert n == n_ref and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_replicate_matches_jax(isos):
    jiso, tiso = isos
    mesh = _mesh(8)
    rep = replicate(tiso.model, mesh)
    assert rep is tiso.model  # one distinct device, the grid's own: the grid itself
    ref = jax_replicate(jiso.model, jax_default_mesh(8))
    np.testing.assert_array_equal(rep.values.numpy(), np.asarray(ref.values))
    for a, b in zip(rep.knots, ref.knots):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert replicate(tiso, mesh) is tiso and replicate(torch.ones(3), mesh).device == CPU


def test_model_copies_for_other_devices(models):
    """What a mesh of several devices builds for each device other than the
    model's: a copy of the model, its interpolator and its priors (shared
    members stay shared), closures built afresh; its posterior equals the
    model's. On the CPU the copy's tensors are the model's own."""
    _, tm = models
    tm.lnpost_batch(_points(4))  # fills the model's closure cache
    copy = tpar._moved(tm, CPU, {})
    assert copy is not tm and copy.ic is not tm.ic and copy._fn_cache == {}
    assert copy._priors["eep"].ic is copy.ic and copy.ic.model is not tm.ic.model
    x = torch.as_tensor(_points())
    assert torch.equal(copy.lnpost_batch(x), tm.lnpost_batch(x))
    by_dev = tpar.ByDevice({CPU: copy._get_fn("lnpost")})
    assert torch.equal(by_dev(x), tm.lnpost_batch(x))


def test_shard_helpers():
    mesh = _mesh(8)
    x = torch.arange(13.0)
    sizes = [len(p) for p in shard_batch(x, mesh)]
    assert sizes == [len(a) for a in np.array_split(np.arange(13), 8)] == tpar.shard_sizes(13, mesh)
    tree = mesh_constrain_leading({"a": x, "b": (x[:, None], None), "c": torch.tensor(2.0)}, mesh)
    assert len(tree) == 8 and [len(t["a"]) for t in tree] == sizes and tree[3]["b"][1] is None
    assert all(t["c"].item() == 2.0 for t in tree)

    calls = []

    def fn(v, w):
        calls.append(len(v))
        return v * 2, {"w": w + v}

    v2, d = mesh_wrap_fn(fn, mesh)(x, x)
    assert torch.equal(v2, 2 * x) and torch.equal(d["w"], 2 * x) and calls == sizes
    # three rows on eight shards: the empty shards are not called
    calls.clear()
    assert torch.equal(mesh_wrap_fn(fn, mesh)(x[:3], x[:3])[0], 2 * x[:3]) and calls == [1, 1, 1]
    # one function per shard, each with its own data
    per = [lambda v, k=k: v + k for k in range(8)]
    assert torch.equal(mesh_wrap_fn(per, mesh)(torch.zeros(8)), torch.arange(8.0))


# ---------------------------------------------------- sharded == unsharded
def test_sharded_fit_mcmc_matches_unsharded(models):
    """Same seed, walkers sharded over 8 shards: the same chain, bitwise."""
    _, tm = models
    p0 = tm.emcee_p0(32, rng=7)
    plain = tm.fit_mcmc(nwalkers=32, nburn=10, niter=10, p0=p0, seed=3)
    shard = tm.fit_mcmc(nwalkers=32, nburn=10, niter=10, p0=p0, seed=3, mesh=_mesh(8))
    assert list(shard) == list(plain)
    for c in plain:
        np.testing.assert_array_equal(shard[c], plain[c])


def test_sharded_nested_multirun_matches_unsharded(models):
    """Independent runs shard over the run axis: the same dead points,
    samples and evidences, bitwise."""
    _, tm = models
    kw = dict(n_live_points=32, max_iter=64, seed=5, n_runs=8, min_ess=0, dlogz=1.0, n_batch=8, n_chains=4,
              n_repeat=4)
    plain = tm.fit_multinest(**kw)
    shard = tm.fit_multinest(mesh=_mesh(8, "runs"), **kw)
    assert shard.logz == plain.logz
    for a, b in ((shard.samples, plain.samples), (shard.logl, plain.logl), (shard.logz_runs, plain.logz_runs)):
        np.testing.assert_array_equal(a, b)


def test_sharded_nested_singlerun_close(models):
    """A single run shards its walk batch; every walk decision, hence the
    dead points and the evidence, within 1e-10."""
    _, tm = models
    kw = dict(n_live_points=64, max_iter=192, seed=5, min_ess=0, dlogz=1.0, n_batch=16, n_chains=4, n_repeat=4)
    plain = tm.fit_multinest(**kw)
    shard = tm.fit_multinest(mesh=_mesh(8), **kw)
    assert abs(shard.logz - plain.logz) < 1e-10
    np.testing.assert_allclose(shard.logl, plain.logl, rtol=1e-10)
    np.testing.assert_allclose(shard.samples, plain.samples, rtol=1e-8, atol=1e-10)


def test_sharded_nuts_engine_matches_unsharded():
    """``run_nuts`` on a correlated Gaussian, 16 chains on 8 shards, each
    shard taking its chains' gradient: the transitions, the pooled warmup
    variance and the generator stay on the first device, so the run is
    bitwise the unsharded one. (The JAX package's chains cross its mesh in
    the pooled variance and agree statistically only.)"""
    from isochrones_torch.samplers.nuts import run_nuts

    prec = torch.as_tensor(np.linalg.inv(np.array([[1.0, 0.8], [0.8, 1.0]])))

    def lnpost(x):  # an elementwise quadratic form: no matmul, whose rounding follows the row count
        return -0.5 * (x[:, :, None] * prec * x[:, None, :]).sum(dim=(-2, -1))

    x0 = torch.as_tensor(np.random.default_rng(0).normal(0, 0.5, (16, 2)))
    runs = []
    for mesh in (None, _mesh(8, "chains")):
        g = torch.Generator()
        g.manual_seed(0)
        runs.append(run_nuts(lnpost, x0, g, n_warmup=60, n_samples=40, max_depth=5, mesh=mesh))
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    assert (runs[0].accept_rate > 0.5).all()


def test_sharded_nuts_matches_unsharded(models):
    """``fit_nuts`` on the star with its chains on 2 shards (and the warm
    start's walkers). On the CPU the plain posterior's ``torch.log`` runs
    SLEEF's vector code over each call's body and libm's over its tail, which
    can differ in the last bit, so a chain's arithmetic depends on how many
    chains share its call: the sharded fit agrees to rounding, not bitwise
    (measured 4.8e-10 relative at these settings), with the same shapes and
    finite draws."""
    _, tm = models
    kw = dict(n_chains=8, n_warmup=12, n_samples=6, max_depth=4, seed=2)
    plain = tm.fit_nuts(**kw)
    plain_res = tm._nuts_result
    shard = tm.fit_nuts(mesh=_mesh(2, "chains"), **kw)
    assert list(shard) == list(plain) and np.isfinite(shard["lnprob"]).all()
    for c in plain:
        np.testing.assert_allclose(shard[c], plain[c], rtol=1e-8)
    for a, b in zip(tm._nuts_result, plain_res):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-8)


def test_run_nested_vmapped_mesh_invariance():
    """A family of 12 shifted Gaussians on 8 shards (uneven): bitwise the
    unsharded family."""
    M, n_live, sigma = 12, 32, 0.08
    centers = torch.as_tensor(np.linspace(0.3, 0.7, M))

    def lnlike_u(c, u):  # (m,), (m, B, 3) -> (m, B)
        return -0.5 * ((u - c[:, None, None]) ** 2).sum(dim=-1) / sigma ** 2

    rng = np.random.default_rng(0)
    u0 = torch.as_tensor(rng.random((M, n_live, 3)))
    lnl0 = lnlike_u(centers, u0)
    kw = dict(n_live=n_live, n_batch=4, n_chains=4, n_repeat=4, n_equal=200, dlogz=0.5, min_ess=20.0, seed=9,
              max_iter=400)
    plain = run_nested_vmapped(lnlike_u, centers, u0, lnl0, **kw)
    shard = run_nested_vmapped(lnlike_u, centers, u0, lnl0, mesh=_mesh(8, "problems"), **kw)
    for key in ("logz", "logzerr", "ess", "samples_u", "lnl", "converged"):
        np.testing.assert_array_equal(shard[key], plain[key])
    assert shard["n_dead"] == plain["n_dead"]


def _table(iso, n_stars, seed):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_stars):
        eep, age = rng.uniform(30, 70), rng.uniform(8.7, 9.3)
        feh, d, av = rng.uniform(-0.2, 0.2), rng.uniform(150, 350), rng.uniform(0, 0.2)
        Teff, _, _, mags = iso.interp_mag([eep, age, feh, d, av], ["J", "H", "K"])
        rows.append(dict(Teff=float(Teff), Teff_unc=100.0, J_mag=float(mags[0]), J_mag_unc=0.02,
                         H_mag=float(mags[1]), H_mag_unc=0.02, parallax=1000.0 / d, parallax_unc=0.1))
    return pd.DataFrame(rows)


def _catalog(iso, n_stars, seed):
    df = _table(iso, n_stars, seed)
    return StarCatalog({c: df[c].values for c in df})


@pytest.mark.parametrize("n_stars", [10, 12])
@pytest.mark.parametrize("method", ["multinest", "mcmc"])
def test_sharded_batch_fitter_matches_unsharded(isos, n_stars, method):
    """The catalog fitter's star axis on 8 shards, each shard's posterior
    holding its own stars' observations: bitwise the unsharded fit."""
    jiso, tiso = isos
    cat = _catalog(jiso, n_stars, seed=n_stars)
    plain, shard = BatchStarFitter(tiso, cat), BatchStarFitter(tiso, cat)
    mesh = _mesh(8, "stars")
    if method == "multinest":
        kw = dict(n_live_points=24, max_iter=96, seed=3, min_ess=0, dlogz=1.0, n_batch=6, n_chains=4, n_repeat=4)
        out_plain = plain.fit_multinest(**kw)
        out_shard = shard.fit_multinest(mesh=mesh, **kw)
        for key in ("logz", "logzerr", "ess"):
            np.testing.assert_array_equal(out_shard[key], out_plain[key])
    else:
        plain.fit_mcmc(nwalkers=16, nburn=10, niter=5, seed=5)
        shard.fit_mcmc(nwalkers=16, nburn=10, niter=5, seed=5, mesh=mesh)
        np.testing.assert_array_equal(shard.sampler_state.n_accept.numpy(), plain.sampler_state.n_accept.numpy())
    np.testing.assert_array_equal(shard.samples, plain.samples)
    np.testing.assert_array_equal(shard._lnprob, plain._lnprob)
    assert [sub.n_stars for sub in shard._shards] == tpar.shard_sizes(n_stars, mesh)


CLUSTER_GRID = dict(n_feh=5, n_mass=20, n_eep=60, n_age=20)
CLUSTER_SIM = dict(age=9.0, feh=0.0, distance=300.0, AV=0.05, alpha=-2.0, gamma=0.3, fB=0.3, bands=("J", "K"),
                   mass_range=(0.6, 2.0))
CLUSTER_MODEL = dict(eep_bounds=(1, 49), eep_step=2.0, max_distance=2000)
CLUSTER_TRUTH = np.array([9.0, 0.0, 300.0, 0.05, -2.0, 0.3, 0.3])


@pytest.fixture(scope="module")
def cluster():
    """One 8-star cluster drawn by the JAX package, the JAX model on its
    8-device mesh of stars, and the port's unsharded model on the same
    catalogue."""
    jiso = jax_get_ichrone("synthetic", **CLUSTER_GRID)
    jsim = JaxSimulatedCluster(8, ic=jiso, rng=0, phot_unc=0.05, **CLUSTER_SIM)
    jm = JaxStarClusterModel(jiso, jsim, mesh=jax_default_mesh(8, axis_names=("stars",)), **CLUSTER_MODEL)
    iso = get_ichrone("synthetic", device="cpu", **CLUSTER_GRID)
    data = {c: jsim.df[c].values for c in jsim.df.columns}
    cat_kw = dict(bands=CLUSTER_SIM["bands"], props=["parallax"])
    return jm, iso, data, cat_kw, StarClusterModel(iso, data, **cat_kw, **CLUSTER_MODEL)


@pytest.mark.parametrize("n_shards", [3, 8, 12])
def test_sharded_cluster_matches_unsharded(cluster, n_shards):
    """The cluster's star axis on 3 (uneven), 8 and 12 (four shards without
    a star) shards: every shard takes all the walkers; the partial sums and
    non-finite counts are summed on the first device. ``lnpost_batch`` and
    ``star_lnmarginals`` (catalog order) within 1e-12 relative of the
    unsharded port, and within 1e-9 (the port's cluster parity bar,
    ``tests/test_torch_cluster_model.py``) of the JAX model sharded over its
    8-device mesh; the non-finite walkers the same in all three."""
    jm, iso, data, cat_kw, plain = cluster
    shard = StarClusterModel(iso, data, mesh=_mesh(n_shards, "stars"), **cat_kw, **CLUSTER_MODEL)
    rng = np.random.default_rng(1)
    p = CLUSTER_TRUTH + rng.normal(0, [0.05, 0.05, 10.0, 0.02, 0.2, 0.05, 0.05], size=(16, 7))
    p[3, 2] = -5.0  # a walker outside the prior box
    ref, got = plain.lnpost_batch(p).numpy(), shard.lnpost_batch(p).numpy()
    jax_ref = np.asarray(jm.lnpost_batch(jnp.asarray(p)))
    fin = np.isfinite(ref)
    assert fin.sum() >= 12
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(np.isfinite(jax_ref), fin)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-12)
    np.testing.assert_allclose(got[fin], jax_ref[fin], rtol=1e-9)
    m_ref, m_got = plain.star_lnmarginals(CLUSTER_TRUTH), shard.star_lnmarginals(CLUSTER_TRUTH)
    assert m_got.shape == (8,) and np.isfinite(m_ref).all()
    np.testing.assert_allclose(m_got, m_ref, rtol=1e-12)
    np.testing.assert_allclose(m_got, jm.star_lnmarginals(CLUSTER_TRUTH).values, rtol=1e-9)


def test_sharded_catalog_lnpost_matches_jax(isos):
    """The catalog posterior with its 12 stars split over 8 shards (each
    shard's stars' parameters against their own observations) against the
    JAX fitter's posterior under its 8-device ``mesh_wrap_fn``, at the
    port's catalog parity bar (atol 1e-10, ``tests/test_torch_batch.py``)
    or, for these prior draws whose posteriors reach -2e5, 1e-12 relative
    (the two packages differ there by a few units in the last place, up to
    2.3e-10 absolute, 1.4e-15 relative); bitwise the port's unsharded
    posterior; the -inf walkers the same."""
    jiso, tiso = isos
    df = _table(jiso, 12, seed=12)
    jf, tf = JaxBatchStarFitter(jiso, df), BatchStarFitter(tiso, StarCatalog({c: df[c].values for c in df}))
    pars = tf.sample_p0(6, rng=1)
    pars[:, 0, 3] = -5.0  # a walker a star at a negative distance
    ref = np.asarray(jax.jit(jax_mesh_wrap_fn(jf.lnpost_batch, jax_default_mesh(8, axis_names=("stars",))))(
        jnp.asarray(pars)))
    got = tf._mesh_lnpost(_mesh(8, "stars"))(torch.as_tensor(pars), None)
    assert [sub.n_stars for sub in tf._shards] == tpar.shard_sizes(12, _mesh(8))
    assert torch.equal(got, tf.lnpost_batch(pars))
    got = got.numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    assert np.isfinite(ref).sum() == 12 * 5
    np.testing.assert_allclose(got[np.isfinite(ref)], ref[np.isfinite(ref)], rtol=1e-12, atol=1e-10)


# ---------------------------------------------------------------- refusals
def test_mesh_refusals(models):
    _, tm = models
    with pytest.raises(ValueError, match="one type"):
        Mesh(["cpu", "meta"])
    if not torch.cuda.is_available():
        for make in (lambda: default_mesh(), lambda: default_mesh(1), lambda: Mesh(["cuda"]),
                     lambda: Mesh(["cuda:0"])):
            with pytest.raises(ValueError, match="CUDA|cuda"):
                make()
    else:
        with pytest.raises(ValueError, match="CUDA devices"):
            default_mesh(torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="device must be"):
        default_mesh(2, device="meta")
    with pytest.raises(ValueError, match="not an axis"):
        shard_batch(torch.ones(4), _mesh(2), axis="stars")
    for call in (lambda m: sharded_lnpost(tm.lnpost_batch, m), lambda m: mesh_wrap_fn(tm.lnpost_batch, m),
                 lambda m: replicate(tm.ic.model, m), lambda m: mesh_constrain_leading(torch.ones(2), m),
                 lambda m: tm.fit_mcmc(nwalkers=8, nburn=1, niter=1, mesh=m)):
        with pytest.raises(TypeError, match="Mesh"):
            call(object())
    # the sampler's state lives on the mesh's first device, which must be the model's
    with pytest.raises(ValueError, match="first device"):
        tm.fit_mcmc(nwalkers=8, nburn=1, niter=1, mesh=Mesh(["meta", "meta"]))
