"""Port parity of the fused tree posterior: the tree likelihood's triple
(``isochrones_torch.ops.tree.tree_lnlike_fused_plain``) and
``isochrones_torch.treemodel.StarModel``'s fused ``lnpost_batch``, against the
JAX package and against the port's composed path, on the CPU in float64, small
synthetic grid (``n_feh=7, n_mass=30, n_eep=100, n_age=30``).

Tolerances: ``ll`` against the JAX ``lnlike_batch`` at rtol 1e-10 with
identical -inf patterns (the bar of ``tests/test_torch_observation.py``); the
two prior columns against the JAX package's and the port's own interpolation
of the full model table at rtol 1e-11 with identical NaN patterns (the same
corners and weights, the columns read from another table); the fused
``lnpost_batch`` against the composed one at 1e-12 (the same arithmetic on the
same two columns, gathered from the 6-column pack instead of the full table)
and against the JAX ``lnpost_batch`` at rtol 1e-10 (the bar of
``tests/test_torch_treemodel.py``), -inf patterns identical in both.
"""

import copy
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isochrones_tpu.ops.interp as jinterp
import isochrones_torch.observation as tobs
from chip_smoke import tree_points
from isochrones_tpu import get_ichrone as jax_get_ichrone
from isochrones_tpu.treemodel import StarModel as JaxStarModel
from isochrones_torch import get_ichrone
from isochrones_torch.ops.interp import interp_nd
from isochrones_torch.ops.tree import (
    TreeLikelihood, tree_lnlike, tree_lnlike_fused, tree_lnlike_fused_plain, tree_lnlike_plain,
)
from isochrones_torch.priors import EEP_prior
from isochrones_torch.treemodel import StarModel

HERE = os.path.dirname(os.path.abspath(__file__))
DIMS = dict(n_feh=7, n_mass=30, n_eep=100, n_age=30)
#: the folders of tests/test_torch_observation.py
FOLDERS = [("star1", {}), ("star2", {}), ("star3", {}), ("star4", {}), ("star4", dict(index=[0, 0, 1])),
           ("star4", dict(index=[0, 1, 1]))]
FOLDER_IDS = ["star1", "star2", "star3", "star4", "star4-001", "star4-011"]
_PHOT = dict(J=(9.5, 0.02), H=(9.2, 0.02), K=(9.1, 0.02), Teff=(5800, 100), parallax=(5.0, 0.05))
#: name -> (folder or None for keyword observations, constructor keywords):
#: one, two and three stars of one system, a two-system tree both ways, and
#: an EEP prior narrower than the grid
MODELS = {
    "one_star": ("star1", {}),
    "two_stars": (None, dict(N=2, **_PHOT)),
    "three_stars": ("star3", {}),
    "two_systems_001": ("star4", dict(index=[0, 0, 1])),
    "two_systems_011": ("star4", dict(index=[0, 1, 1])),
    "narrow_eep_bounds": ("star3", dict(eep_bounds=(20, 80))),
}


class ComposedStarModel(StarModel):
    """The tree model held to its composed posterior (lnprior + lnlike)."""

    def _build_lnpost_fused(self):
        return None


@pytest.fixture(scope="module")
def ics():
    return jax_get_ichrone("synthetic", **DIMS), get_ichrone("synthetic", device="cpu", **DIMS)


def _build(cls, ic, folder, kw):
    if folder is None:
        return cls(ic, **kw)
    return cls.from_ini(ic, os.path.join(HERE, folder), **kw)


def _points(tm, n=320, seed=0):
    """Seeded points: half over the grid's whole box with the adversarial
    blocks of ``tree_points`` (knots, top knots, one star off the grid, NaN;
    EEPs in no order), half in the narrow box where most are finite."""
    knots = tm.ic.model.knots
    pts = tree_points(tm.param_names, knots, n, seed=seed)
    pts[n // 2:] = tree_points(tm.param_names, knots, n - n // 2, seed=seed + 1, narrow=True)
    return pts


def _posterior_points(tm, seed=1):
    """Prior-transform draws (descending EEPs, inside every bound) followed
    by the adversarial points of :func:`_points`: off the grid, out of order,
    outside the prior's bounds."""
    u = np.random.default_rng(seed).random((384, tm.n_params))
    return np.concatenate([tm.prior_transform_batch(torch.as_tensor(u)).numpy(), _points(tm, 256, seed=seed + 1)])


@pytest.mark.parametrize("folder, kw", FOLDERS, ids=FOLDER_IDS)
def test_fused_plain_ll_matches_jax(ics, folder, kw):
    jm, tm = _build(JaxStarModel, ics[0], folder, kw), _build(StarModel, ics[1], folder, kw)
    pts = _points(tm)
    ref = np.asarray(jm.lnlike_batch(jnp.asarray(pts)))
    fused = tobs.make_tree_lnlike_fused(tm.obs.plan(ics[1]))
    lk = fused.likelihood
    assert isinstance(lk, TreeLikelihood) and lk.model is ics[1].model_packed6
    ll, orig_val, deriv = tree_lnlike_fused_plain(torch.as_tensor(pts), lk)
    got = ll.numpy()
    assert orig_val.shape == deriv.shape == (len(pts), lk.n_stars)
    assert not np.isnan(got).any()
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), fin) and (got[~fin] == -np.inf).all()
    assert 32 < fin.sum() < len(pts) - 32
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-10)
    # a CPU tensor takes the plain version through every name of the call
    for other in (tree_lnlike_fused(torch.as_tensor(pts), lk), fused(torch.as_tensor(pts))):
        for a, b in zip(other, (ll, orig_val, deriv)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(tree_lnlike_plain(torch.as_tensor(pts), lk).numpy(), got)
    np.testing.assert_array_equal(tree_lnlike(torch.as_tensor(pts), lk).numpy(), got)
    np.testing.assert_array_equal(tm.lnlike_batch(pts).numpy(), got)


@pytest.mark.parametrize("folder, kw", FOLDERS, ids=FOLDER_IDS)
def test_prior_columns_match_jax_and_port_prior(ics, folder, kw):
    """``orig_val`` and ``deriv`` per star are the two columns that the JAX
    package's and the port's ``EEP_prior`` interpolate from the full table."""
    jic, tic = ics
    jm, tm = _build(JaxStarModel, jic, folder, kw), _build(StarModel, tic, folder, kw)
    plan = tm.obs.plan(tic)
    pts = _points(tm, seed=4)
    _, orig_val, deriv = tree_lnlike_fused_plain(torch.as_tensor(pts), TreeLikelihood.from_plan(plan))
    jprior, tprior = jm._priors["eep"], tm._priors["eep"]
    io = tic._param_index_order
    n_nan = 0
    for r, idx in enumerate(np.asarray(plan.star_param_idx)):
        star = pts[:, idx]  # (n, 5): eep, age, feh, distance, AV
        gp = np.stack([star[:, io[0]], star[:, io[1]], star[:, io[2]]], axis=-1)
        jvals = np.asarray(jinterp.interp_nd(jic.model.values, jic.model.knots, jnp.asarray(gp),
                                             icols=(jprior._icol_orig, jprior._icol_deriv),
                                             axis_maps=jic.model.axis_maps))
        tvals = interp_nd(tic.model.values, tic.model.knots, torch.as_tensor(gp),
                          icols=(tprior._icol_orig, tprior._icol_deriv), axis_maps=tic.model.axis_maps).numpy()
        for got, k in ((orig_val[:, r].numpy(), 0), (deriv[:, r].numpy(), 1)):
            for ref in (jvals[:, k], tvals[:, k]):
                assert np.array_equal(np.isnan(got), np.isnan(ref))
                np.testing.assert_allclose(got, ref, rtol=1e-11, equal_nan=True)
        n_nan += int(np.isnan(tvals[:, 0]).sum())
        # the prior's term from the two columns is the prior's own lnpdf
        ov, dv, eep = orig_val[:, r], deriv[:, r], torch.as_tensor(star[:, 0])
        term = tprior.orig_prior.lnpdf(ov) + torch.log(torch.clamp(dv, min=1e-300))
        term = torch.where(torch.isfinite(ov) & (dv > 0), term, float("-inf"))
        lo, hi = tprior.bounds
        term = torch.where((eep < lo) | (eep > hi), float("-inf"), term).numpy()
        own = tprior.lnpdf(eep, age=torch.as_tensor(star[:, 1]), feh=torch.as_tensor(star[:, 2])).numpy()
        assert np.array_equal(np.isfinite(term), np.isfinite(own))
        np.testing.assert_allclose(term[np.isfinite(own)], own[np.isfinite(own)], rtol=1e-11)
    assert n_nan > 0 and np.isfinite(orig_val.numpy()).sum() > 100


@pytest.mark.parametrize("name", list(MODELS))
def test_fused_lnpost_matches_composed_and_jax(ics, name):
    jic, tic = ics
    folder, kw = MODELS[name]
    tm, cm, jm = _build(StarModel, tic, folder, kw), _build(ComposedStarModel, tic, folder, kw), _build(JaxStarModel, jic, folder, kw)
    assert tm._build_lnpost_fused() is not None and tm._get_fn("lnpost").likelihood.n_stars == len(tm.obs.get_model_nodes())
    pts = _posterior_points(tm)
    eep_cols = [i for i, n in enumerate(tm.param_names) if n.startswith("eep")]
    lo, hi = tm._priors["eep"].bounds
    outside = ((pts[:, eep_cols] < lo) | (pts[:, eep_cols] > hi)).any(axis=1)
    assert outside.sum() > 8  # EEPs outside the prior's bounds are among the points
    got = tm.lnpost_batch(pts).numpy()
    composed = cm.lnpost_batch(pts).numpy()
    ref = np.asarray(jm.lnpost_batch(jnp.asarray(pts)))
    assert not np.isnan(got).any() and (got[outside] == -np.inf).all()
    fin = np.isfinite(composed)
    assert np.array_equal(np.isfinite(got), fin) and np.array_equal(np.isfinite(ref), fin)
    assert fin.sum() > 20 and (~fin).sum() > 20
    np.testing.assert_allclose(got[fin], composed[fin], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-10)
    # the prior and the likelihood alone stay the composed ones
    np.testing.assert_array_equal(tm.lnprior_batch(pts).numpy(), cm.lnprior_batch(pts).numpy())
    np.testing.assert_array_equal(tm.lnlike_batch(pts).numpy(), cm.lnlike_batch(pts).numpy())
    p = pts[fin][0]
    assert tm.lnpost(p) == pytest.approx(jm.lnpost(p), rel=1e-10)


@pytest.mark.parametrize("rule", ["descending_eeps", "nonpositive_derivative", "nan_parameter"])
def test_fused_lnpost_minus_inf_rules(ics, rule):
    """Each rule of the fused prior gives -inf where the composed one does."""
    tic = copy.deepcopy(ics[1])
    if rule == "nonpositive_derivative":
        # a grid whose dm_deep is negative or zero over part of the EEP axis,
        # in the full table (the composed path) and in the pack (the fused)
        col = tic.model.column_index["dm_deep"]
        tic.model.values[:, :, 40:60, col] *= -1.0
        tic.model.values[:, :, 60:70, col] = 0.0
        tic.model_packed6.values[..., 5] = tic.model.values[..., col]
    path = os.path.join(HERE, "star3")
    tm, cm = StarModel.from_ini(tic, path), ComposedStarModel.from_ini(tic, path)
    u = np.random.default_rng(5).random((512, tm.n_params))
    pts = tm.prior_transform_batch(torch.as_tensor(u)).numpy()
    before = np.isfinite(StarModel.from_ini(ics[1], path).lnpost_batch(pts).numpy())
    if rule == "descending_eeps":
        pts[::2, :3] = pts[::2, 2::-1]  # ascending
    elif rule == "nan_parameter":
        pts[::2, np.arange(256) % tm.n_params] = np.nan
    got, composed = tm.lnpost_batch(pts).numpy(), cm.lnpost_batch(pts).numpy()
    fin = np.isfinite(composed)
    assert not np.isnan(got).any() and np.array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], composed[fin], rtol=1e-12, atol=1e-12)
    assert fin.sum() > 8 and (before & ~fin).sum() > 8  # the rule fired, and not everywhere
    if rule == "nonpositive_derivative":
        deriv = tm._get_fn("lnpost").likelihood.model.values[..., 5]
        assert (deriv < 0).any() and (deriv == 0).any()


class _ScaledEEPPrior(EEP_prior):
    def lnpdf(self, eep, **kwargs):
        return super().lnpdf(eep, **kwargs) - 1.0


class _OtherLikelihood(StarModel):
    def _build_lnlike_batch(self):
        inner = super()._build_lnlike_batch()
        return lambda p: inner(p) - 2.0


@pytest.mark.parametrize("custom", ["eep_prior_subclass", "eep_prior_of_another_grid", "likelihood_override"])
def test_customized_model_takes_composed_path(ics, custom):
    tic = ics[1]
    path = os.path.join(HERE, "star3")
    base = StarModel.from_ini(tic, path)
    pts = _posterior_points(base, seed=7)
    ref = base.lnpost_batch(pts).numpy()
    fin = np.isfinite(ref)
    if custom == "likelihood_override":
        tm, shift = _OtherLikelihood.from_ini(tic, path), -2.0
    else:
        tm = StarModel.from_ini(tic, path)
        assert tm._build_lnpost_fused() is not None
        if custom == "eep_prior_subclass":
            tm.set_prior(eep=_ScaledEEPPrior(tic, tm._priors["mass"]))
            shift = -3.0  # one term per star
        else:
            tm.set_prior(eep=EEP_prior(copy.deepcopy(tic), tm._priors["mass"]))
            shift = 0.0
    assert tm._build_lnpost_fused() is None
    got = tm.lnpost_batch(pts).numpy()
    assert np.array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], ref[fin] + shift, rtol=1e-12, atol=1e-10)


def test_tree_likelihood_needs_the_prior_columns(ics):
    tic = copy.copy(ics[1])
    tic.model_packed6 = None
    tm = StarModel.from_ini(ics[1], os.path.join(HERE, "star1"))
    with pytest.raises(ValueError, match="EEP-prior columns"):
        TreeLikelihood.from_plan(tobs.compile_plan(tm.obs, tic))
    with pytest.raises(ValueError, match="cpu or cuda"):
        tree_lnlike_fused(torch.zeros((2, 5), device="meta"), TreeLikelihood.from_plan(tm.obs.plan(ics[1])))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
@pytest.mark.parametrize("case", ["star3", "two_systems", "density_and_limits"])
def test_pack_plan_layout(ics, case, dtype):
    """The block that the CUDA wrapper hands the kernel, decoded as the
    kernel's header lays it out, gives back the plan's arrays."""
    from isochrones_torch.ops.tree_cuda import MAX_STARS, pack_plan

    tic = ics[1]
    if case == "star3":
        tm = StarModel.from_ini(tic, os.path.join(HERE, "star3"))
    elif case == "two_systems":
        tm = StarModel.from_ini(tic, os.path.join(HERE, "star4"), index=[0, 0, 1])
    else:
        tm = StarModel(tic, N=2, density=(1.4, 0.3), AV=(0.1, 0.05), **_PHOT)
        tm.obs.add_limit(logg=(3.5, None))
        tm.obs.add_limit(label="0_1", density=(None, 50.0))
    lk = TreeLikelihood.from_plan(tm.obs.plan(tic))
    raw = pack_plan(lk, dtype).tobytes()
    assert len(raw) % 16 == 0
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    pos = 0
    for name in ("obs_val", "obs_unc", "spec_val", "spec_unc", "lim_lo", "lim_hi", "plax_val", "plax_unc", "av_val",
                 "av_unc"):
        want = getattr(lk, name).numpy().astype(np_dtype)
        got = np.frombuffer(raw, dtype=np_dtype, count=len(want), offset=pos)
        np.testing.assert_array_equal(got, want, err_msg=name)
        pos += want.nbytes
    words = np.frombuffer(raw, dtype=np.uint32, count=(lk.n_obs + len(lk.spec_star) + len(lk.lim_star)
                                                       + len(lk.plax_idx) + len(lk.av_idx)), offset=pos)
    assert len(raw) - (pos + words.nbytes) < 16
    obs, rest = words[:lk.n_obs].astype(np.int64), words[lk.n_obs:]
    np.testing.assert_array_equal(obs & 15, lk.obs_band.numpy())
    np.testing.assert_array_equal(((obs >> 4) & 127) - 1, lk.obs_ref.numpy())
    np.testing.assert_array_equal((obs >> 11) & 1, lk.obs_active.numpy())
    np.testing.assert_array_equal((obs[:, None] >> (16 + np.arange(lk.n_stars))) & 1, lk.member.numpy())
    for k in ("spec", "lim"):
        n = len(getattr(lk, f"{k}_star"))
        np.testing.assert_array_equal(rest[:n] & 255, getattr(lk, f"{k}_star").numpy())
        np.testing.assert_array_equal(rest[:n] >> 8, getattr(lk, f"{k}_prop").numpy())
        rest = rest[n:]
    np.testing.assert_array_equal(rest, np.concatenate([lk.plax_idx.numpy(), lk.av_idx.numpy()]))
    assert int(lk.obs_active.sum()) > 0 and (case != "star3" or int((lk.obs_ref >= 0).sum()) > 0)
    if dtype == torch.float64:
        many = StarModel(tic, N=MAX_STARS + 1, **_PHOT)
        with pytest.raises(ValueError, match="MAX_STARS"):
            pack_plan(TreeLikelihood.from_plan(many.obs.plan(tic)), dtype)
        half = dataclasses.replace(lk, member=lk.member * 0.5)
        with pytest.raises(ValueError, match="0 and 1"):
            pack_plan(half, dtype)


@pytest.mark.parametrize("entry", ["tree_load_hdf", "flat_load_hdf", "from_ini", "cli", "clusterfit",
                                   "clusterfit_cli", "simulated_cluster"])
def test_entry_points_default_to_the_card(ics, tmp_path, entry):
    """Without a device the entry points build on the card; with no card
    that fails instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    import shutil

    from isochrones_torch import SingleStarModel
    from isochrones_torch.cli.starfit import main

    if entry in ("clusterfit", "clusterfit_cli", "simulated_cluster"):
        from isochrones_torch.cli.clusterfit import main as clusterfit_main
        from isochrones_torch.cluster import SimulatedCluster, clusterfit

        csv = os.path.join(os.path.dirname(HERE), "isochrones_torch", "data", "cluster50_synthetic.csv")
        with pytest.raises((RuntimeError, AssertionError)):  # torch's own refusal, by build
            if entry == "clusterfit":
                clusterfit(csv, models="synthetic", nlive=20, max_iter=20)
            elif entry == "clusterfit_cli":
                clusterfit_main(["--models", "synthetic", "--nlive", "20", "--max_iter", "20", csv])
            else:
                SimulatedCluster(5, 9.0, 0.0, 300.0, 0.05, -2.0, 0.3, 0.3, n_feh=3, n_mass=8, n_eep=30, n_age=8)
        return
    folder = str(tmp_path / "star1")
    shutil.copytree(os.path.join(HERE, "star1"), folder)
    if entry == "cli":
        assert main(["--models", "synthetic", "--no_plots", "--n_live_points", "40", "--max_iter", "80", folder]) == 1
        assert not [f for f in os.listdir(folder) if f.endswith(".h5")]
        return
    if entry == "from_ini":
        with pytest.raises((RuntimeError, AssertionError)):  # torch's own refusal, by build
            StarModel.from_ini("synthetic", folder)
        return
    cls = StarModel if entry == "tree_load_hdf" else SingleStarModel
    mod = StarModel.from_ini(ics[1], folder) if cls is StarModel else SingleStarModel(ics[1], **_PHOT)
    mod._samples = {c: np.zeros(3) for c in mod.param_names + ("lnprob",)}
    mod._derived_samples = {"lnprob": np.zeros(3)}
    path = str(tmp_path / "model.h5")
    mod.save_hdf(path)
    assert cls.load_hdf(path, device="cpu").device.type == "cpu"
    with pytest.raises((RuntimeError, AssertionError)):
        cls.load_hdf(path)


@pytest.mark.parametrize("name", ["one_star", "two_stars", "two_systems_001"])
def test_convert_pars_to_eep_matches_jax(ics, name):
    """Mass-based parameter vectors become EEP-based ones through the
    isochrone grid's accurate inversion; the EEPs agree to 1e-9 (Newton
    iterates of the same residual), the shared parameters exactly."""
    folder, kw = MODELS[name]
    jm, tm = _build(JaxStarModel, ics[0], folder, kw), _build(StarModel, ics[1], folder, kw)
    masses = [1.1, 0.8, 0.6]
    pars, i = [], 0
    for s in tm.obs.systems:
        n = tm.obs.Nstars[s]
        pars += masses[i: i + n] + [9.3 + 0.1 * i, -0.1, 180.0 + i, 0.12]
        i += n
    ref = jm.convert_pars_to_eep(pars)
    got = tm.convert_pars_to_eep(pars)
    assert len(got) == len(ref) == tm.n_params
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)
    eeps = [got[j] for j, p in enumerate(tm.obs.param_description) if p.startswith("eep")]
    assert all(np.isfinite(e) and e != m for e, m in zip(eeps, masses))
    assert np.isfinite(tm.lnpost(got))


def test_fit_mcmc_refuses_mesh(ics):
    """``mesh`` is named and checked by both engines, not swallowed: an
    object that is not a :class:`~isochrones_torch.parallel.Mesh` is refused."""
    from isochrones_torch import SingleStarModel

    for mod in (SingleStarModel(ics[1], **_PHOT), _build(StarModel, ics[1], "star1", {})):
        with pytest.raises(TypeError, match="Mesh"):
            mod.fit_mcmc(nwalkers=8, nburn=1, niter=1, mesh=object())
        with pytest.raises(TypeError, match="Mesh"):
            mod.fit(n_live_points=20, mesh=object())
