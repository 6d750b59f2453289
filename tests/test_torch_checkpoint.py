"""Checkpoint and resume of the port's nested sampler
(``isochrones_torch.samplers.nested``), the cases of
``tests/test_checkpoint.py`` on the CPU: a run stopped at a chunk boundary
(or a thread-round boundary, for dynamic nested sampling) and resumed gives
BITWISE the run that never stopped; a checkpoint of another configuration,
of another problem or of the JAX package is refused.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isochrones_torch.samplers.nested as tn
from isochrones_tpu.samplers.nested import run_nested as jax_run_nested
from isochrones_torch import SingleStarModel, get_ichrone
from isochrones_torch.samplers.nested import CheckpointConfigError, run_nested

MU = torch.tensor([0.3, -0.2], dtype=torch.float64)
SIG = torch.tensor([0.15, 0.1], dtype=torch.float64)
KW = dict(n_live=100, n_batch=8, n_chains=4, n_repeat=8)


def lnpost_v(x):
    mu, sig = MU.to(x.dtype), SIG.to(x.dtype)
    return -0.5 * (((x - mu) / sig) ** 2 + torch.log(2 * np.pi * sig ** 2)).sum(-1)


def prior_transform(u):
    return u * 4.0 - 2.0  # box [-2, 2]^2


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _run(seed=3, rng=5, **kw):
    return run_nested(lnpost_v, prior_transform, 2, _gen(seed), rng=rng, **{**KW, **kw})


def _assert_same(a, b):
    assert (a.logz, a.logzerr, a.ess, a.n_iter, a.dynamic_rounds) == (b.logz, b.logzerr, b.ess, b.n_iter, b.dynamic_rounds)
    for name in ("samples", "logl", "logwt", "posterior", "logl_posterior"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_single_run_resume_bitwise(tmp_path, dtype):
    """Stop a static run after one full chunk (256 dead points); the resumed
    run is bitwise the uninterrupted one."""
    full = _run(dtype=dtype)
    ck = str(tmp_path / "ns.ckpt")
    part = _run(max_iter=256, checkpoint=ck, dtype=dtype)
    assert os.path.exists(ck) and part.n_iter == 256 < full.n_iter
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]  # written atomically, nothing left over
    resumed = _run(checkpoint=ck, resume=True, dtype=dtype)
    _assert_same(full, resumed)
    assert resumed.samples.dtype == full.samples.dtype


def test_single_run_checkpoint_keeps_its_layout(tmp_path):
    """A single run's checkpoint holds its arrays without the family's
    problem axis, and its threads as one list of segments, so that the
    checkpoints written before single runs stepped as families of one
    resume."""
    ck = str(tmp_path / "ns.ckpt")
    _run(max_iter=256, checkpoint=ck)
    with open(ck, "rb") as f:
        state = pickle.load(f)
    assert (state["config"]["kind"], state["phase"], state["thread_segments"]) == ("single", "base", None)
    assert state["dead_u"].shape == (256, 2) and state["dead_lnl"].shape == (256,)
    assert state["live_u"].shape == (100, 2) and state["live_lnl"].shape == (100,)
    assert isinstance(state["scale"], np.ndarray) and state["scale"].shape == ()
    assert np.ndim(state["running_log_s1"]) == np.ndim(state["running_log_s2"]) == 0

    ck = str(tmp_path / "dyn.ckpt")
    _run(seed=7, rng=9, checkpoint=ck, dynamic=True, min_ess=1200, max_dynamic_rounds=1)
    with open(ck, "rb") as f:
        state = pickle.load(f)
    assert state["phase"] == "dynamic" and state["dynamic_rounds"] == 1
    thread, = state["thread_segments"]
    assert thread["dead_lnl"].ndim == 1 and thread["all_u"].shape == (len(thread["dead_lnl"]) + 100, 2)


def test_single_run_resume_after_complete_is_stable(tmp_path):
    ck = str(tmp_path / "ns.ckpt")
    full = _run(checkpoint=ck)
    mtime = os.path.getmtime(ck)
    again = _run(checkpoint=ck, resume=True)
    _assert_same(full, again)
    assert os.path.getmtime(ck) == mtime  # no chunk ran, nothing was written
    fresh = _run(checkpoint=str(tmp_path / "missing.ckpt"), resume=True)  # a missing file starts fresh
    _assert_same(full, fresh)


def test_dynamic_resume_bitwise(tmp_path):
    """Stop a dynamic run after its first thread round; the resumed run, and
    one resumed from the end of the base run, are bitwise the uninterrupted
    one."""
    kw = dict(dynamic=True, min_ess=1200)
    full = _run(seed=7, rng=9, **kw)
    assert full.dynamic_rounds >= 2, "the fixture must need two thread rounds"
    ck = str(tmp_path / "dyn.ckpt")
    part = _run(seed=7, rng=9, checkpoint=ck, max_dynamic_rounds=1, **kw)
    assert part.dynamic_rounds == 1 and part.truncated
    with open(ck, "rb") as f:
        assert pickle.load(f)["phase"] == "dynamic"
    resumed = _run(seed=7, rng=9, checkpoint=ck, resume=True, **kw)
    _assert_same(full, resumed)

    ck0 = str(tmp_path / "base.ckpt")
    base = _run(seed=7, rng=9, checkpoint=ck0, max_dynamic_rounds=0, **kw)
    assert base.dynamic_rounds == 0
    _assert_same(full, _run(seed=7, rng=9, checkpoint=ck0, resume=True, **kw))


def test_config_and_tag_mismatch_raise(tmp_path):
    ck = str(tmp_path / "ns.ckpt")
    _run(max_iter=256, checkpoint=ck, config_tag="data-hash-A")
    with pytest.raises(ValueError, match="different sampler configuration"):
        _run(checkpoint=ck, resume=True, config_tag="data-hash-A", n_live=120)
    with pytest.raises(CheckpointConfigError, match="different sampler configuration"):
        _run(checkpoint=ck, resume=True, config_tag="data-hash-B")
    with pytest.raises(CheckpointConfigError, match="different sampler configuration"):
        _run(checkpoint=ck, resume=True, config_tag="data-hash-A", dtype=torch.float32)
    resumed = _run(checkpoint=ck, resume=True, config_tag="data-hash-A")  # the right tag resumes
    assert resumed.n_iter > 256


def test_jax_checkpoint_is_refused(tmp_path):
    """A checkpoint that the JAX package wrote holds a JAX key where the port
    keeps a generator state: it is refused, not misread; so is another
    version's."""
    ck = str(tmp_path / "jax.ckpt")

    def jax_lnpost(x):
        return -0.5 * jnp.sum(((x - MU.numpy()) / SIG.numpy()) ** 2, axis=-1)

    jax_run_nested(jax_lnpost, prior_transform, 2, jax.random.PRNGKey(3), rng=5, max_iter=256, checkpoint=ck, **KW)
    with pytest.raises(CheckpointConfigError, match="different sampler configuration"):
        _run(checkpoint=ck, resume=True)
    with open(ck, "rb") as f:
        state = pickle.load(f)
    state["config"]["version"] = 1
    tn._ckpt_save(ck, state)
    with pytest.raises(CheckpointConfigError, match="version"):
        _run(checkpoint=ck, resume=True)


def test_fit_multinest_checkpoint_handling(tmp_path):
    """``fit_multinest``: ``checkpoint=True`` writes under the chains
    basename; ``resume=True, overwrite=True`` deletes the stale checkpoint
    and refits; another seed refuses to resume; a resumed model fit is
    bitwise the uninterrupted one."""
    ic = get_ichrone("synthetic", device="cpu", n_feh=5, n_mass=20, n_eep=60, n_age=20)
    Teff, logg, _, mags = ic.interp_mag([35.0, 9.0, 0.0, 200.0, 0.1], ["J", "K"])
    obs = dict(Teff=(float(Teff), 100.0), logg=(float(logg), 0.1), J=(float(mags[0]), 0.02), K=(float(mags[1]), 0.02),
               parallax=(5.0, 0.05))
    model = SingleStarModel(ic, name="ckpt-ow", directory=str(tmp_path), **obs)
    kw = dict(n_live_points=60, seed=1, n_batch=8, n_chains=4)
    model.fit_multinest(max_iter=256, checkpoint=True, **kw)
    ck = str(tmp_path / "chains" / "ckpt-ow-iso-single-checkpoint.pkl")
    assert model.mnest_basename + "checkpoint.pkl" == ck and os.path.exists(ck)
    mtime = os.path.getmtime(ck)

    loads = []
    orig_load = tn._ckpt_load
    try:
        tn._ckpt_load = lambda p, c: (loads.append(p), orig_load(p, c))[1]
        model.fit_multinest(max_iter=256, resume=True, overwrite=True, **kw)
    finally:
        tn._ckpt_load = orig_load
    assert loads == [] and os.path.getmtime(ck) > mtime  # refit fresh, a new checkpoint written

    with pytest.raises(CheckpointConfigError):
        model.fit_multinest(**{**kw, "seed": 2}, resume=True)

    resumed = model.fit_multinest(resume=True, **kw)
    fresh = SingleStarModel(ic, name="fresh", directory=str(tmp_path), **obs)
    full = fresh.fit_multinest(**kw)
    _assert_same(full, resumed)
    for c in fresh.samples:
        np.testing.assert_array_equal(fresh.samples[c], model.samples[c])
    assert not os.path.exists(fresh.mnest_basename + "checkpoint.pkl")  # no checkpoint unless asked
