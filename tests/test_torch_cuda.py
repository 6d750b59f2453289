"""The CUDA kernels on the card against their plain PyTorch versions.

Marked ``cuda``: every test skips without a CUDA card. This file imports no
JAX, so it also runs on a machine without it, from the repository root:

    python -m pytest --noconftest -o filterwarnings=error -m cuda tests/test_torch_cuda.py

Tolerances are those of ``chip_smoke.py``. Cluster kernel: rtol 1e-10 in
float64 (another summation order); float32 against the float64 plain version
on the same float32 inputs within 1e-3 + 1e-4 |ref| (float32 rounding of
sums over ~1e3-1e5 cells); the finite pattern must be identical and the
kernel never returns NaN. Star kernel: rtol 1e-10 in float64 and 0.05 + 1e-4
|ref| for float32 against the float64 plain version on the same float32
tables and points, with identical NaN and +-inf patterns, for N = 1, 2, 3
and every axis-map kind, on adversarial points.
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import (
    ATOL_F32, ATOL_STAR_F32, FIXTURE, RTOL_F32, RTOL_F64, RTOL_STAR_F32, RTOL_STAR_F64, as_float32, check_close,
    check_star, grid_as, make_kernel_inputs, star_grid_variant, star_observations, star_points, to_torch,
)
from isochrones_torch import BinaryStarModel, StarClusterModel, TripleStarModel, get_ichrone
from isochrones_torch.catalog import read_csv
from isochrones_torch.ops.cluster import cluster_lnmarginal, cluster_lnmarginal_plain
from isochrones_torch.ops.cluster_cuda import cluster_lnmarginal_cuda
from isochrones_torch.ops.star import star_lnlike_fused, star_lnlike_fused_plain
from isochrones_torch.ops.star_cuda import star_lnlike_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("S,E,B,W", [(7, 50, 4, 3), (9, 33, 1, 2), (17, 130, 6, 4), (3, 1, 2, 1)])
@pytest.mark.parametrize("q_jacobian", [False, True])
def test_kernel_matches_plain_f64(dev, S, E, B, W, q_jacobian):
    a, kw = to_torch(make_kernel_inputs(S, E, B, W, seed=S * E), dev, torch.float64)
    ref = cluster_lnmarginal_plain(*a, q_jacobian=q_jacobian, **kw).cpu().numpy()
    got = cluster_lnmarginal_cuda(*a, q_jacobian=q_jacobian, **kw)
    torch.cuda.synchronize()
    check_close("f64", got.cpu().numpy(), ref, RTOL_F64)


def test_kernel_matches_plain_f32(dev):
    inputs = as_float32(make_kernel_inputs(11, 90, 3, 4, seed=5))
    a32, kw32 = to_torch(inputs, dev, torch.float32)
    a64, kw64 = to_torch(inputs, dev, torch.float64)
    got = cluster_lnmarginal_cuda(*a32, **kw32).cpu().numpy()
    check_close("f32", got, cluster_lnmarginal_plain(*a64, **kw64).cpu().numpy(), RTOL_F32, ATOL_F32)


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
    cpu = StarClusterModel(get_ichrone("synthetic", **grid), data, **kw)
    rng = np.random.default_rng(0)
    truth = np.array([9.0, 0.0, 300.0, 0.05, -2.0, 0.3, 0.3])
    p = truth + rng.normal(0, [0.05, 0.05, 5.0, 0.01, 0.1, 0.03, 0.03], size=(12, 7))
    check_close("slice", gpu.lnpost_batch(p).cpu().numpy(), cpu.lnpost_batch(p).numpy(), 1e-9)


_SMALL = dict(n_feh=7, n_mass=30, n_eep=100, n_age=30)
#: a binary inside the small grid: EEPs 60 and 40, age, feh, distance, AV
_SMALL_TRUTH = (60.0, 40.0, 9.0, 0.0, 200.0, 0.1)


def _likelihood(dev, dtype, N, kind, drop=()):
    """A fused-likelihood description on the small grid with the axes of
    ``kind`` and the bench's observations less ``drop``."""
    from isochrones_torch import SingleStarModel

    ic = get_ichrone("synthetic", device=dev, dtype=dtype, **_SMALL)
    obs = {k: v for k, v in star_observations(get_ichrone("synthetic", **_SMALL), _SMALL_TRUTH).items() if k not in drop}
    if "logg" in drop:
        obs["logg"] = (float("nan"), 0.1)  # a missing channel
    model = {1: SingleStarModel, 2: BinaryStarModel, 3: TripleStarModel}[N](ic, **obs)
    lk = model._star_likelihood()
    pack6, bc = star_grid_variant(lk.pack6, lk.bc, kind)
    return dataclasses.replace(lk, pack6=pack6, bc=bc)


@pytest.mark.parametrize("kind", ["default", "log", "compare", "searchsorted"])
@pytest.mark.parametrize("N", [1, 2, 3])
def test_star_kernel_matches_plain(dev, N, kind):
    lk64 = _likelihood(dev, torch.float64, N, kind)
    pts = star_points(lk64.pack6.knots, N, 4096, seed=N)
    p64 = torch.as_tensor(pts, device=dev, dtype=torch.float64)
    ref = [x.cpu().numpy() for x in star_lnlike_fused_plain(p64, lk64)]
    got = [x.cpu().numpy() for x in star_lnlike_cuda(p64, lk64)]
    check_star(f"f64 N={N} {kind}", got, ref, RTOL_STAR_F64)
    assert np.isfinite(ref[0]).sum() > 100 and np.isnan(ref[0]).sum() > 100

    lk32 = dataclasses.replace(lk64, pack6=grid_as(lk64.pack6, torch.float32), bc=grid_as(lk64.bc, torch.float32))
    lk32up = dataclasses.replace(lk64, pack6=grid_as(lk32.pack6, torch.float64), bc=grid_as(lk32.bc, torch.float64))
    p32 = p64.float()
    ref32 = [x.cpu().numpy() for x in star_lnlike_fused_plain(p32.double(), lk32up)]
    got32 = [x.cpu().numpy() for x in star_lnlike_cuda(p32, lk32)]
    check_star(f"f32 N={N} {kind}", got32, ref32, RTOL_STAR_F32, ATOL_STAR_F32)


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

    obs = star_observations(get_ichrone("synthetic", **_SMALL), _SMALL_TRUTH)
    gpu = BinaryStarModel(get_ichrone("synthetic", device=dev, **_SMALL), **obs)
    cpu = BinaryStarModel(get_ichrone("synthetic", **_SMALL), **obs)
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
