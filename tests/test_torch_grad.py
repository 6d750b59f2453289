"""Gradients of the port's posteriors against ``jax.grad`` of the JAX
package's, and the kernel wrappers' gradient guard.

On the CPU in float64, small synthetic grids: ``torch.autograd`` through
``lnpost_batch`` of the flat models (N = 1, 2, 3), the tree ``StarModel``,
``IsoTrackModel`` and a model with a missing spectroscopic channel, at seeded
points off the grid knots, equals ``jax.grad`` of the JAX ``lnpost_batch``
row by row to 1e-9 of the row's scale (``max(1, max |grad|)``: the same
closed forms, other rounding), and is finite wherever lnpost is finite. The
plain likelihoods' rule that the backward kernels keep (a non-finite output
passes no gradient) holds on adversarial points. The guard: a wrapper
without a backward kernel raises where autograd would record it, before it
touches a device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import isotrack_points, star_points, tree_points
from isochrones_tpu import get_ichrone as jax_get_ichrone
from isochrones_tpu import starmodel as jsm
from isochrones_tpu.treemodel import StarModel as JaxStarModel
from isochrones_torch import get_ichrone
from isochrones_torch import starmodel as tsm
from isochrones_torch.ops._grad import refuse_grad
from isochrones_torch.ops.star import star_lnlike_fused_plain
from isochrones_torch.ops.tree import tree_lnlike_fused_plain
from isochrones_torch.treemodel import StarModel

_DIMS = dict(n_feh=7, n_mass=30, n_eep=100, n_age=30)
_TRACK_DIMS = dict(n_feh=5, n_mass=20, n_eep=60, n_age=20)
_TRUTH = [60.0, 9.0, 0.0, 200.0, 0.1]
_CLASSES = {1: "SingleStarModel", 2: "BinaryStarModel", 3: "TripleStarModel"}
#: |torch - jax| <= RTOL * max(1, max |jax grad| of the row)
RTOL = 1e-9


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ics():
    return get_ichrone("synthetic", device="cpu", **_DIMS), jax_get_ichrone("synthetic", **_DIMS)


def _observations(jic, missing_feh=False):
    Teff, logg, feh, mags = jic.interp_mag(_TRUTH, ["J", "H", "K", "G"])
    obs = dict(Teff=(float(Teff), 100.0), logg=(float(logg), 0.1), parallax=(5.0, 0.05))
    if not missing_feh:
        obs["feh"] = (float(feh), 0.1)
    obs.update({b: (float(m), 0.02) for b, m in zip("JHKG", np.asarray(mags))})
    return obs


def _near_points(N, n, seed):
    """Seeded rows in the model's box near the truth (EEPs descending), off
    the grid knots."""
    rng = np.random.default_rng(seed)
    pts = np.empty((n, N + 4))
    pts[:, :N] = np.sort(rng.uniform(20, 90, (n, N)), axis=1)[:, ::-1]
    pts[:, N:] = np.asarray(_TRUTH[1:]) + rng.normal(0, [0.3, 0.2, 20.0, 0.05], (n, 4))
    pts[:, N + 3] = np.abs(pts[:, N + 3])
    return pts


def _torch_grad(fn, pts):
    x = torch.tensor(pts, dtype=torch.float64, requires_grad=True)
    lp = fn(x)
    (g,) = torch.autograd.grad(lp.sum(), x)
    return lp.detach().numpy(), g.numpy()


def _check_parity(tm, jm, pts, min_finite):
    lp, g = _torch_grad(tm.lnpost_batch, pts)
    f = jm.lnpost_batch
    jlp = np.asarray(f(jnp.asarray(pts)))
    jg = np.asarray(jax.grad(lambda p: f(p).sum())(jnp.asarray(pts)))
    fin = np.isfinite(lp)
    assert np.array_equal(fin, np.isfinite(jlp))
    assert fin.sum() >= min_finite, f"only {fin.sum()} finite rows"
    assert np.isfinite(g[fin]).all(), "a non-finite gradient where lnpost is finite"
    scale = np.maximum(1.0, np.abs(jg[fin]).max(axis=1, keepdims=True))
    err = np.abs(g[fin] - jg[fin]) / scale
    assert err.max() <= RTOL, f"max error {err.max():.3e} of the row's scale"


@pytest.mark.parametrize("N", [1, 2, 3])
def test_flat_gradient_matches_jax(ics, N):
    tic, jic = ics
    obs = _observations(jic)
    tm, jm = getattr(tsm, _CLASSES[N])(tic, **obs), getattr(jsm, _CLASSES[N])(jic, **obs)
    assert tm._build_lnpost_fused() is not None
    _check_parity(tm, jm, _near_points(N, 128, seed=N), min_finite=48)


def test_missing_channel_gradient_matches_jax(ics):
    """No [Fe/H] measurement (its channel NaN), as ``tests/test_nuts.py``'s
    regression: the gradient stays finite and equals the JAX package's."""
    tic, jic = ics
    obs = _observations(jic, missing_feh=True)
    tm, jm = tsm.SingleStarModel(tic, **obs), jsm.SingleStarModel(jic, **obs)
    assert np.isnan(tm._star_likelihood().spec_vals[2])
    _check_parity(tm, jm, _near_points(1, 128, seed=11), min_finite=64)


def test_tree_gradient_matches_jax(ics):
    tic, jic = ics
    import os

    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)), "star3")
    tm, jm = StarModel.from_ini(tic, folder), JaxStarModel.from_ini(jic, folder)
    assert tm._build_lnpost_fused() is not None
    pts = tree_points(tm.param_names, [k.numpy() for k in tic.model.knots], 512, seed=3, narrow=True)[64:]
    _check_parity(tm, jm, pts, min_finite=32)


def test_isotrack_gradient_matches_jax():
    iso, track = (get_ichrone("synthetic", device="cpu", **_TRACK_DIMS),
                  get_ichrone("synthetic", tracks=True, device="cpu", **_TRACK_DIMS))
    jiso, jtrack = jax_get_ichrone("synthetic", **_TRACK_DIMS), jax_get_ichrone("synthetic", tracks=True, **_TRACK_DIMS)
    truth = [30.0, 9.0, 0.0, 200.0, 0.1]
    Teff, logg, _, mags = jiso.interp_mag(truth, ["J", "H", "K"])
    obs = dict(Teff=(float(Teff), 100.0), logg=(float(logg), 0.1), parallax=(5.0, 0.05))
    obs.update({b: (float(m), 0.02) for b, m in zip("JHK", np.asarray(mags))})
    tm, jm = tsm.IsoTrackModel(iso, track, **obs), jsm.IsoTrackModel(jiso, jtrack, **obs)
    pts = isotrack_points(tm, 512, seed=5)[256:]  # the rows whose age is the track's
    rng = np.random.default_rng(6)
    pts = pts + rng.normal(0, 1e-4, pts.shape)  # off the knots
    _check_parity(tm, jm, pts, min_finite=16)


@pytest.mark.parametrize("N", [1, 2])
def test_star_plain_gradient_rule(ics, N):
    """A non-finite output passes no gradient: on adversarial rows (knots,
    out of bounds, NaN, AV past the BC grid, distance <= 0) the gradient for
    finite cotangents is finite everywhere, and 0 on a row whose three
    outputs are all non-finite."""
    tic, jic = ics
    tm = getattr(tsm, _CLASSES[N])(tic, **_observations(jic))
    lk = tm._star_likelihood()
    pts = star_points(tic.model.knots, N, 512, seed=N)
    x = torch.tensor(pts, requires_grad=True)
    outs = star_lnlike_fused_plain(x, lk)
    rng = np.random.default_rng(0)
    cot = [torch.as_tensor(rng.normal(size=o.shape)) for o in outs]
    (g,) = torch.autograd.grad(outs, x, grad_outputs=cot)
    g = g.numpy()
    assert np.isfinite(g).all()
    dead = ~np.isfinite(outs[0].detach().numpy()) & ~np.isfinite(outs[1].detach().numpy()).any(axis=1)
    dead &= ~np.isfinite(outs[2].detach().numpy()).any(axis=1)
    assert dead.sum() > 0 and (g[dead] == 0).all()


def test_tree_plain_gradient_rule(ics):
    import os

    tic, _ = ics
    tm = StarModel.from_ini(tic, os.path.join(os.path.dirname(os.path.abspath(__file__)), "star3"))
    lk = tm._get_fn("lnlike").likelihood
    pts = tree_points(tm.param_names, [k.numpy() for k in tic.model.knots], 512, seed=9)
    x = torch.tensor(pts, requires_grad=True)
    outs = tree_lnlike_fused_plain(x, lk)
    rng = np.random.default_rng(1)
    cot = [torch.as_tensor(rng.normal(size=o.shape)) for o in outs]
    (g,) = torch.autograd.grad(outs, x, grad_outputs=cot)
    assert np.isfinite(g.numpy()).all()


def test_no_graph_without_grad(ics):
    """The nested and ensemble samplers' calls (tensors that need no
    gradient) build no graph."""
    tic, jic = ics
    tm = tsm.BinaryStarModel(tic, **_observations(jic))
    out = tm.lnpost_batch(torch.as_tensor(_near_points(2, 16, seed=0)))
    assert not out.requires_grad and out.grad_fn is None


def test_refuse_grad_logic():
    a = torch.zeros(3, requires_grad=True)
    b = torch.zeros(3)
    refuse_grad("k", b, None, 1.0)
    with pytest.raises(RuntimeError, match="k has no backward kernel"):
        refuse_grad("k", b, a)
    with torch.no_grad():
        refuse_grad("k", a)
    refuse_grad("k", a.detach())


def _catalog_call():
    from isochrones_torch.ops.catalog_cuda import catalog_lnlike_cuda

    return lambda x: catalog_lnlike_cuda(x, None)


def _catalog_post_call():
    from isochrones_torch.ops.catalog_cuda import catalog_lnpost_cuda

    return lambda x: catalog_lnpost_cuda(x, None, None)


def _cluster_call():
    from isochrones_torch.ops.cluster_cuda import cluster_lnmarginal_cuda

    return lambda x: cluster_lnmarginal_cuda(x, *([None] * 13))


def _generate_call(name):
    import isochrones_torch.ops.generate_cuda as gc

    fn = getattr(gc, name)
    if name == "eep_newton_cuda":
        return lambda x: fn(None, x, x, x, x)
    if name in ("get_eep_cuda", "get_eep_accurate_cuda"):
        return lambda x: fn(None, x, x, x)
    return lambda x: fn(None, x, x, x, x, x, (), ())


@pytest.mark.parametrize("wrapper", ["catalog_lnlike_cuda", "catalog_lnpost_cuda", "cluster_lnmarginal_cuda",
                                     "generate_cuda", "generate_accurate_cuda", "get_eep_cuda",
                                     "get_eep_accurate_cuda", "eep_newton_cuda"])
def test_wrappers_without_backward_raise(wrapper):
    """Every wrapper without a backward kernel refuses a graph first, before
    any check or launch (so this runs without a card)."""
    call = {"catalog_lnlike_cuda": _catalog_call, "catalog_lnpost_cuda": _catalog_post_call,
            "cluster_lnmarginal_cuda": _cluster_call}.get(wrapper, lambda: _generate_call(wrapper))()
    x = torch.zeros(4, requires_grad=True)
    with pytest.raises(RuntimeError, match=f"{wrapper} has no backward kernel"):
        call(x)
