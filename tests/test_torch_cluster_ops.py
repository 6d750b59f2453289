"""Port parity: the plain cluster marginal of ``isochrones_torch.ops.cluster``
against the JAX package's XLA grid path and its Pallas kernel (interpret
mode), on the cases of ``tests/test_cluster_pallas.py``.

Tolerances: rtol 1e-10 against the XLA grid path (same algorithm, same
float64 operations up to summation order) and rtol 1e-8 against the Pallas
kernel (streaming log-sum-exp and ``log1p(-fB)`` instead of ``log(1 - fB)``
differ at the rounding level), as the JAX tests hold the two JAX paths.
The finite/-inf pattern must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isochrones_tpu.ops.cluster import calc_lnlike_grid as jax_calc_lnlike_grid
from isochrones_tpu.ops.cluster import integrate_over_eeps_ln as jax_integrate_ln
from isochrones_tpu.ops.cluster_pallas import cluster_lnmarginal_pallas
from isochrones_tpu.ops.cluster_pallas import trapezoid_weights as jax_trapezoid_weights
from isochrones_torch.ops.cluster import (
    calc_lnlike_grid,
    cluster_lnmarginal,
    cluster_lnmarginal_plain,
    integrate_over_eeps_ln,
)
from isochrones_torch.ops.cluster_cuda import trapezoid_weights

_SCALARS = ("alpha", "gamma", "fB", "mass_lo", "mass_hi", "q_lo")


def _fixture(seed, S=7, E=50, B=4, invalid_frac=0.1):
    """numpy inputs of one walker, made as in tests/test_cluster_pallas.py."""
    rng = np.random.default_rng(seed)
    eeps = np.sort(rng.uniform(200, 400, E))
    masses = np.sort(rng.uniform(0.3, 2.0, E))
    model_mags = rng.normal(10, 2, (E, B))
    ln_dm = rng.normal(-3, 0.5, E)
    valid = rng.random(E) > invalid_frac
    lnprop = rng.normal(-2, 1, (S, E))
    mag_values = rng.normal(10, 2, (S, B))
    mag_uncs = rng.uniform(0.05, 0.2, (S, B))
    return dict(
        lnlike_prop=lnprop, model_mags=np.where(valid[:, None], model_mags, 0.0),
        masses=np.where(valid, masses, 1.0), ln_dm_deeps=np.where(valid, ln_dm, 0.0),
        eeps=eeps, mag_values=mag_values, mag_uncs=mag_uncs, alpha=-2.35, gamma=0.3,
        fB=0.4, mass_lo=0.3, mass_hi=2.0, q_lo=0.2, valid=valid,
    )


def _jax(kw):
    return {k: (v if k in _SCALARS else jnp.asarray(v)) for k, v in kw.items()}


def _port(kws, q_jacobian=False, valid_k=None):
    """Stack one or more single-walker fixtures into the port's batched call."""
    t = lambda k: torch.as_tensor(np.stack([kw[k] for kw in kws]))  # noqa: E731
    kw0 = kws[0]
    out = cluster_lnmarginal(
        t("lnlike_prop"), t("model_mags"), t("masses"), t("ln_dm_deeps"),
        torch.as_tensor(kw0["eeps"]), torch.as_tensor(kw0["mag_values"]),
        torch.as_tensor(kw0["mag_uncs"]),
        *(torch.tensor([kw[k] for kw in kws], dtype=torch.float64) for k in ("alpha", "gamma", "fB")),
        kw0["mass_lo"], kw0["mass_hi"], kw0["q_lo"],
        valid=t("valid"), q_jacobian=q_jacobian,
        valid_k=None if valid_k is None else torch.as_tensor(np.stack(valid_k)),
    )
    return out.numpy()


def _xla(kw, q_jacobian=False, valid_k=None):
    j = _jax(kw)
    grid = jax_calc_lnlike_grid(
        j["lnlike_prop"], j["model_mags"], j["masses"], j["ln_dm_deeps"], j["mag_values"],
        j["mag_uncs"], j["alpha"], j["gamma"], j["fB"], j["mass_lo"], j["mass_hi"], j["q_lo"],
        valid=j["valid"], q_jacobian=q_jacobian,
        valid_k=None if valid_k is None else jnp.asarray(valid_k),
    )
    return np.asarray(jax_integrate_ln(grid, j["eeps"]))


def _pallas(kw, q_jacobian=False, valid_k=None):
    return np.asarray(cluster_lnmarginal_pallas(
        **_jax(kw), interpret=True, tile_j=16, q_jacobian=q_jacobian,
        valid_k=None if valid_k is None else jnp.asarray(valid_k),
    ))


def _assert_match(got, ref, rtol):
    m = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), m)
    np.testing.assert_allclose(got[m], ref[m], rtol=rtol)


def test_calc_lnlike_grid_matches_jax():
    kw = _fixture(0, S=4, E=30, B=3)
    args = [kw[k] for k in ("lnlike_prop", "model_mags", "masses", "ln_dm_deeps", "mag_values", "mag_uncs")]
    ref = np.asarray(jax_calc_lnlike_grid(*map(jnp.asarray, args), *(kw[k] for k in _SCALARS),
                                          valid=jnp.asarray(kw["valid"])))
    got = calc_lnlike_grid(*map(torch.as_tensor, args), *(kw[k] for k in _SCALARS),
                           valid=torch.as_tensor(kw["valid"])).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(ref))
    m = np.isfinite(ref)
    np.testing.assert_allclose(got[m], ref[m], rtol=1e-12)
    np.testing.assert_allclose(
        integrate_over_eeps_ln(torch.as_tensor(got), torch.as_tensor(kw["eeps"])).numpy(),
        np.asarray(jax_integrate_ln(jnp.asarray(ref), jnp.asarray(kw["eeps"]))), rtol=1e-12,
    )


def test_trapezoid_weights_identity():
    """W-weighted sum-of-exp == the double trapezoid for any masked plane:
    the closed form the CUDA kernel evaluates per cell."""
    rng = np.random.default_rng(3)
    E, S = 37, 5
    eeps = torch.as_tensor(np.sort(rng.uniform(0, 10, E)))
    lnl = torch.as_tensor(rng.normal(-3, 2, (S, E, E)))
    mask = torch.as_tensor(rng.random((E, E)) > 0.3) & torch.ones((E, E), dtype=torch.bool).tril()
    ref = torch.exp(integrate_over_eeps_ln(torch.where(mask[None], lnl, float("-inf")), eeps))
    w = trapezoid_weights(eeps, mask)
    got = (torch.exp(lnl) * w[None]).sum(dim=(1, 2))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12)
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(jax_trapezoid_weights(jnp.asarray(eeps.numpy()), jnp.asarray(mask.numpy())))
    )


@pytest.mark.parametrize("seed,S,E,B", [(0, 7, 50, 4), (1, 3, 130, 2), (2, 9, 64, 6)])
def test_parity_randomized(seed, S, E, B):
    kw = _fixture(seed, S=S, E=E, B=B)
    got = _port([kw])[0]
    _assert_match(got, _xla(kw), rtol=1e-10)
    _assert_match(got, _pallas(kw), rtol=1e-8)


def test_parity_inf_lnprop_and_all_invalid_star():
    kw = _fixture(5, S=4, E=40, B=3)
    lnprop = kw["lnlike_prop"].copy()
    lnprop[0, 3] = -np.inf
    lnprop[1, :] = np.nan
    lnprop[2, :] = -np.inf  # star with zero marginal likelihood
    kw["lnlike_prop"] = lnprop
    got = _port([kw])[0]
    ref = _pallas(kw)
    assert not np.isfinite(ref[2]) and got[2] == -np.inf
    _assert_match(got, ref, rtol=1e-8)
    _assert_match(got, _xla(kw), rtol=1e-10)


def test_parity_narrow_valid_window():
    kw = _fixture(0, S=4, E=40, B=3)
    valid = np.zeros(40, dtype=bool)
    valid[5:8] = True
    kw.update(valid=valid, model_mags=np.where(valid[:, None], kw["model_mags"], 0.0),
              masses=np.where(valid, np.sort(np.random.default_rng(0).uniform(0.3, 2.0, 40)), 1.0),
              ln_dm_deeps=np.where(valid, kw["ln_dm_deeps"], 0.0))
    got = _port([kw])[0]
    _assert_match(got, _xla(kw), rtol=1e-10)
    ref = _pallas(kw)
    m = np.isfinite(got)
    np.testing.assert_allclose(got[m], ref[m], rtol=1e-8)


def test_dead_star_minus_inf():
    kw = _fixture(3, S=4, E=40, B=3)
    kw["lnlike_prop"][1, :] = -np.inf
    got = _port([kw])[0]
    assert got[1] == -np.inf
    assert np.isfinite(got[[0, 2, 3]]).all()
    _assert_match(got, _pallas(kw), rtol=1e-8)


@pytest.mark.parametrize("q_jacobian", [False, True])
def test_parity_q_jacobian_and_valid_k(q_jacobian):
    """Both q-prior modes, with a secondary-row mask that differs from the
    primary one (valid_k is kept separate from valid)."""
    kw = _fixture(9, S=4, E=40, B=3)
    valid_k = kw["valid"] | (np.arange(40) % 7 == 0)
    got = _port([kw], q_jacobian=q_jacobian, valid_k=[valid_k])[0]
    _assert_match(got, _xla(kw, q_jacobian, valid_k), rtol=1e-10)
    _assert_match(got, _pallas(kw, q_jacobian, valid_k), rtol=1e-8)


def test_walker_batch_matches_per_walker():
    """A walker batch with per-walker parameters and ladders equals each
    walker evaluated alone (the batch the kernel takes in one launch)."""
    base = _fixture(7, S=5, E=40, B=3)
    kws = []
    for i, fb in enumerate((0.2, 0.5, 0.8)):
        kw = _fixture(7 + i, S=5, E=40, B=3)
        kw.update(eeps=base["eeps"], mag_values=base["mag_values"], mag_uncs=base["mag_uncs"],
                  fB=fb, alpha=-2.35 + 0.3 * i, gamma=0.3 - 0.1 * i)
        kws.append(kw)
    got = _port(kws)
    for i, kw in enumerate(kws):
        _assert_match(got[i], _xla(kw), rtol=1e-10)
        _assert_match(got[i], _port([kw])[0], rtol=1e-13)


def test_plain_chunking_is_exact(monkeypatch):
    """Star chunks (the plain version's memory bound) change nothing."""
    import isochrones_torch.ops.cluster as ops_cluster

    kw = _fixture(11, S=7, E=30, B=3)
    full = _port([kw])
    monkeypatch.setattr(ops_cluster, "_PLAIN_CELL_BUDGET", 2 * 30 * 30)  # 2 stars per chunk
    np.testing.assert_array_equal(_port([kw]), full)


def test_dispatch_cpu_is_plain():
    kw = _fixture(13, S=4, E=30, B=3)
    t = {k: (v if k in _SCALARS else torch.as_tensor(v)) for k, v in kw.items()}
    args = [t[k][None] if k not in ("eeps", "mag_values", "mag_uncs") else t[k]
            for k in ("lnlike_prop", "model_mags", "masses", "ln_dm_deeps", "eeps", "mag_values", "mag_uncs")]
    sc = [torch.tensor([kw[k]], dtype=torch.float64) for k in ("alpha", "gamma", "fB")]
    plain = cluster_lnmarginal_plain(*args, *sc, kw["mass_lo"], kw["mass_hi"], kw["q_lo"], valid=t["valid"][None])
    np.testing.assert_array_equal(_port([kw]), plain.numpy())


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never computes on the CPU: the dispatcher is the
    only place that picks the plain version, by device."""
    from isochrones_torch.ops.cluster_cuda import cluster_lnmarginal_cuda

    kw = _fixture(13, S=4, E=30, B=3)
    t = lambda k: torch.as_tensor(kw[k])[None]  # noqa: E731
    sc = [torch.tensor([kw[k]], dtype=torch.float64) for k in ("alpha", "gamma", "fB")]
    with pytest.raises(ValueError, match="CUDA"):
        cluster_lnmarginal_cuda(
            t("lnlike_prop"), t("model_mags"), t("masses"), t("ln_dm_deeps"), torch.as_tensor(kw["eeps"]),
            torch.as_tensor(kw["mag_values"]), torch.as_tensor(kw["mag_uncs"]), *sc,
            kw["mass_lo"], kw["mass_hi"], kw["q_lo"], t("valid"),
        )


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises instead of falling back."""
    from isochrones_torch.ops import _build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
