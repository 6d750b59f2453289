"""Population synthesis of the port on the CPU, float64: the cases of
``tests/test_populations.py`` (exact N, deredden equals regeneration at
AV = 0, no NaN total magnitude, the A_x addmags identity, corner cases, the
star formation history grid, the binary distribution) on
``isochrones_torch.populations``, then parity with the JAX package: the same
seed draws the same systems and gives the same stars, column by column;
``generate-cmd-torch`` writes the table of the JAX ``generate-cmd``; and the
sampling helpers the populations lean on (``powerlaw_pdf``,
``powerlaw_lnpdf``, ``Prior.test_sampling``, ``fast_addmags``,
``band_pairs``) against the JAX functions.

Tolerances are those of ``tests/test_torch_generate.py`` (rtol 1e-10, NaN
patterns identical), with its one stated exception, the FMA knife edge, which
applies to single rows of a raw draw. A knife-edge row is kept by the JAX
package and dropped by the port, so the rows of an ``exact_N`` frame after
it differ: the frames are compared whole up to the first such row.
"""

import csv

import numpy as np
import pytest
import torch

import isochrones_tpu.priors as jpriors
import isochrones_tpu.utils as jutils
import isochrones_torch.priors as tpriors
import isochrones_torch.utils as tutils
from isochrones_tpu import get_ichrone as jax_get_ichrone
from isochrones_tpu.cli.generate_cmd import main as jax_generate_cmd
from isochrones_tpu.populations import StarPopulation as JaxStarPopulation
from isochrones_torch import get_ichrone
from isochrones_torch.cli.generate_cmd import main as generate_cmd
from isochrones_torch.populations import (
    BinaryDistribution, StarFormationHistory, StarFormationHistoryGrid, StarPopulation, deredden,
)
from isochrones_torch.priors import AVPrior, DistancePrior, GaussianPrior, SalpeterPrior
from isochrones_torch.summary import Frame
from isochrones_torch.utils import addmags
from test_torch_generate import DIMS, assert_columns_close, knife_edge_rows

N_STARS = 500
SEED = 42


def _population(ic, priors):
    return (JaxStarPopulation if priors is jpriors else StarPopulation)(
        ic, imf=priors.SalpeterPrior(bounds=(0.4, 8)), fB=0.4, gamma=0.3, sfh=None,
        feh=priors.GaussianPrior(-0.2, 0.2), distance=priors.DistancePrior(max_distance=3000),
        AV=priors.AVPrior(bounds=[0, 2]))


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)
    ic = get_ichrone("synthetic", device="cpu", **DIMS)
    pop = _population(ic, tpriors)
    df = pop.generate(N_STARS, rng=SEED)
    return ic, pop, df, deredden(df)


def _regenerate_at_av0(ic, df):
    """The reference's old_deredden oracle (test_populations.py:10-24)."""
    return ic.generate_binary(df["initial_mass_0"], df["initial_mass_1"], df["requested_age_0"],
                              df["initial_feh_0"], distance=df["distance_0"], AV=0.0, all_As=True)


def test_exact_n(setup):
    _, _, df, _ = setup
    assert isinstance(df, Frame) and len(df["mass_0"]) == N_STARS
    assert not np.isnan(df["mass_0"]).any()
    np.testing.assert_array_equal(df._labels(), np.arange(N_STARS))


def test_deredden_equals_regeneration(setup):
    ic, _, df, dered = setup
    old = _regenerate_at_av0(ic, df)
    common = [c for c in dered.columns if c in old.columns]
    assert len(common) > 50
    for c in common:
        np.testing.assert_allclose(np.nan_to_num(dered[c]), np.nan_to_num(old[c]), rtol=0, atol=1e-8, err_msg=c)


def test_no_null_total_mags(setup):
    ic, _, df, _ = setup
    assert not any(np.isnan(df[f"{b}_mag"]).any() for b in ic.bands)


def test_dereddening_preserves_params(setup):
    _, _, df, dered = setup
    for c in ("initial_mass_0", "initial_feh_0", "requested_age_0"):
        np.testing.assert_array_equal(df[c], dered[c])
    assert dered is not df and not np.shares_memory(dered["J_mag"], df["J_mag"])


def test_av_consistency(setup):
    ic, _, df, dered = setup
    single = ~(df["mass_1"] > 0)
    for b in ic.bands[:3]:
        diff = (dered[f"{b}_mag"] + df[f"A_{b}_0"]) - df[f"{b}_mag"]
        assert diff[single].std() < 1e-4


def test_extinction_addmags_identity(setup):
    ic, _, df, dered = setup
    b = ic.bands[0]
    rhs = addmags(dered[f"{b}_mag_0"] + df[f"A_{b}_0"],
                  np.nan_to_num(dered[f"{b}_mag_1"] + df[f"A_{b}_1"], nan=np.inf))
    np.testing.assert_array_almost_equal(df[f"{b}_mag"], rhs)


def test_generate_corner_cases(setup):
    _, pop, _, _ = setup
    for i in range(5):
        assert len(pop.generate(10, rng=i)["mass_0"]) == 10
    loose = pop.generate(40, exact_N=False, rng=7)
    assert not np.isnan(loose["mass_0"]).any() and len(loose["mass_0"]) <= 40
    assert (np.diff(loose._labels()) > 0).all()  # the kept rows' own labels


def test_exact_n_pads_after_max_rounds(setup, caplog):
    """No draw meets the grid: after ``max_rounds`` the frame is NaN rows and
    a warning is logged."""
    ic, _, _, _ = setup
    pop = StarPopulation(ic, imf=SalpeterPrior(bounds=(20.0, 30.0)), feh=GaussianPrior(-0.2, 0.2))
    df = pop.generate(5, rng=0, max_rounds=2)
    assert len(df["mass_0"]) == 5 and np.isnan(df["mass_0"]).all()
    assert "only 0/5 valid rows" in caplog.text


def test_sfh_grid():
    t = np.array([1.0, 2.0, 5.0, 10.0])
    sfh = StarFormationHistoryGrid(t, np.array([0.0, 1.0, 1.0, 0.5]))
    ages = sfh.sample_ages(1000, rng=0)
    assert np.isfinite(ages).all()
    assert (10 ** ages / 1e9 <= 10.0).all()
    ages_u = StarFormationHistory().sample_ages(1000, rng=0)
    assert (ages_u < 10.0).all() and np.isfinite(ages_u).all()


def test_binary_distribution():
    bd = BinaryDistribution(SalpeterPrior(bounds=(0.4, 8)), fB=0.5, gamma=0.3)
    pri, sec = bd.sample(2000, rng=0)
    assert ((sec > 0).mean() - 0.5) < 0.05
    mask = sec > 0
    q = sec[mask] / pri[mask]
    assert (q >= 0.2).all() and (q <= 1.0).all()


# ---------------------------------------------------------------- parity


@pytest.fixture(scope="module")
def both():
    return _population(jax_get_ichrone("synthetic", **DIMS).track, jpriors), \
        _population(get_ichrone("synthetic", device="cpu", **DIMS).track, tpriors)


def _inputs(pop, N, seed):
    """The systems that ``_draw`` draws from this seed: (primary, secondary,
    log age, [Fe/H]) from a generator of the same seed."""
    rng = np.random.default_rng(seed)
    pri, sec = pop.binary_distribution.sample(N, rng=rng)
    return pri, sec, pop.sfh.sample_ages(N, rng=rng), pop.feh.sample(N, rng=rng)


def _edge_rows(jpop, tpop, N, seed, jdraw, tdraw):
    """The knife-edge rows of one raw draw, each checked for its kind (both
    components)."""
    pri, sec, age, feh = _inputs(tpop, N, seed)
    for a, b in zip((pri, sec, age, feh), _inputs(jpop, N, seed)):
        np.testing.assert_array_equal(a, b)  # the same seed draws the same systems
    mass, ages, fehs = np.concatenate([pri, sec]), np.tile(age, 2), np.tile(feh, 2)
    nan_t = np.concatenate([np.isnan(tdraw["mass_0"]), np.isnan(tdraw["mass_1"])])
    nan_j = np.concatenate([np.isnan(jdraw["mass_0"]), np.isnan(jdraw["mass_1"])])
    knife_edge_rows(tpop.ic.get_eep(mass, ages, fehs), jpop.ic.get_eep(mass, ages, fehs), nan_t, nan_j)
    return (nan_t != nan_j).reshape(2, -1).any(axis=0)


def test_raw_draw_matches_jax(both):
    jpop, tpop = both
    M = int(np.ceil(N_STARS * 1.25)) + 16
    jdraw = jpop._draw(M, np.random.default_rng(SEED), False)
    tdraw = tpop._draw(M, np.random.default_rng(SEED), False)
    skip = _edge_rows(jpop, tpop, M, SEED, jdraw, tdraw)
    assert_columns_close(tdraw, {c: jdraw[c].values for c in jdraw.columns}, skip_rows=skip)
    assert 300 < int(np.isfinite(tdraw["mass_0"]).sum()) < M


@pytest.mark.parametrize("seed", [SEED, 3])
def test_exact_n_frame_matches_jax(both, seed):
    """The whole ``exact_N`` frame, up to the first knife-edge row of the
    first draw round (past it the two packages keep different rows)."""
    jpop, tpop = both
    ref = jpop.generate(N_STARS, rng=seed)
    got = tpop.generate(N_STARS, rng=seed)
    M = int(np.ceil(N_STARS * 1.25)) + 16
    first = tpop._draw(M, np.random.default_rng(seed), False)
    edge = _edge_rows(jpop, tpop, M, seed, jpop._draw(M, np.random.default_rng(seed), False), first)
    n_same = int(np.isfinite(first["mass_0"][: np.argmax(edge)]).sum()) if edge.any() else N_STARS
    assert n_same > 50
    assert_columns_close({c: v[:n_same] for c, v in got.items()}, {c: ref[c].values[:n_same] for c in ref.columns})


def test_generate_cmd_matches_jax(tmp_path):
    out, ref = tmp_path / "torch.csv", tmp_path / "jax.csv"
    assert generate_cmd(["40", "--device", "cpu", "--models", "synthetic", "--seed", "0", "-o", str(out)]) == 0
    assert jax_generate_cmd(["40", "--platform", "cpu", "--models", "synthetic", "--seed", "0", "-o", str(ref)]) == 0
    rows = []
    for f in (out, ref):
        with open(f, newline="") as fh:
            rows.append(list(csv.reader(fh)))
    assert rows[0][0] == rows[1][0] and len(rows[0]) == len(rows[1]) == 41
    for a, b in zip(rows[0][1:], rows[1][1:]):
        for name, x, y in zip(rows[0][0], a, b):
            if x in ("True", "False", "") or y in ("True", "False", ""):
                assert x == y, name
            else:
                assert float(x) == pytest.approx(float(y), rel=1e-10, abs=1e-12), name


# ------------------------------------------------ sampling helpers


@pytest.mark.parametrize("case", ["powerlaw_pdf", "powerlaw_lnpdf", "test_sampling", "fast_addmags", "band_pairs"])
def test_sampling_helpers_match_jax(case):
    rng = np.random.default_rng(1)
    if case in ("powerlaw_pdf", "powerlaw_lnpdf"):
        x = rng.uniform(0.1, 3.0, 200)
        for alpha, lo, hi in ((-2.35, 0.1, 3.0), (0.3, 0.2, 1.0)):
            got = getattr(tpriors, case)(torch.as_tensor(x), alpha, lo, hi)
            ref = np.asarray(getattr(jpriors, case)(x, alpha, lo, hi))
            np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-12)
            np.testing.assert_allclose(np.asarray(getattr(tpriors, case)(x, alpha, lo, hi)), ref, rtol=1e-12)
    elif case == "test_sampling":
        for make in (lambda p: p.SalpeterPrior(bounds=(0.4, 8)), lambda p: p.GaussianPrior(-0.2, 0.2, bounds=(-1, 1)),
                     lambda p: p.FlatPrior((0, 2))):
            make(tpriors).test_sampling(n=20000, rng=0)
            make(jpriors).test_sampling(n=20000, rng=0)
            np.testing.assert_array_equal(make(tpriors).sample(100, rng=0), make(jpriors).sample(100, rng=0))
        with pytest.raises(AssertionError):  # a sampler that disagrees with its pdf
            bad = tpriors.FlatPrior((0, 2))
            bad.sample = lambda n, rng=None: np.random.default_rng(rng).uniform(0, 1, n)
            bad.test_sampling(n=20000, rng=0)
    elif case == "fast_addmags":
        for mags in (np.array([10.0, 11.0, 12.5]), [9.0], 8.5, np.array([10.0, np.inf])):
            assert tutils.fast_addmags(mags) == jutils.fast_addmags(mags)
    else:
        for bands in (["J", "H", "K"], ["G"], ("BP", "RP", "G", "W1")):
            assert tutils.band_pairs(bands) == jutils.band_pairs(bands)
