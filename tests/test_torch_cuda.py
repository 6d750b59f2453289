"""The CUDA kernel on the card against its plain PyTorch version.

Marked ``cuda``: every test skips without a CUDA card. This file imports no
JAX, so it also runs on a machine without it, from the repository root:

    python -m pytest --noconftest -o filterwarnings=error -m cuda tests/test_torch_cuda.py

Tolerances are those of ``chip_smoke.py``: rtol 1e-10 in float64 (another
summation order); float32 against the float64 plain version on the same
float32 inputs within 1e-3 + 1e-4 |ref| (float32 rounding of sums over
~1e3-1e5 cells). The finite pattern must be identical and the kernel never
returns NaN.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    ATOL_F32, FIXTURE, RTOL_F32, RTOL_F64, as_float32, check_close, make_kernel_inputs, to_torch,
)
from isochrones_torch import StarClusterModel, get_ichrone
from isochrones_torch.catalog import read_csv
from isochrones_torch.ops.cluster import cluster_lnmarginal, cluster_lnmarginal_plain
from isochrones_torch.ops.cluster_cuda import cluster_lnmarginal_cuda

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
