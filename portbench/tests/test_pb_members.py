"""The cluster cells' members made again without the program.

Each cluster configuration's members were written once by the program's
``SimulatedCluster`` (its ``members_made_by``). Here they are drawn again in
plain numpy from the same seed, in the order that recipe documents (binary
flags, primary masses, mass ratios, distances, then the noise band by band,
with every member whose photometry is not finite drawn again), and their
magnitudes computed by ``portbench.reference`` on the configuration's frozen
tables. So the data the cells compare against do not rest on the program's
simulator alone.

The one step taken from the program is each member's EEP: it inverts mass
along its evolution tracks. Here the EEP comes from the isochrone table's
mass at the cluster's age, which agrees to a little over one EEP (at most
1.17 on either file) and to 0.01 mag in the magnitudes made from it, half the
photometric noise; the stored EEPs themselves give the stored magnitudes to
rounding.
"""

import functools

import numpy as np
import pytest
import torch

from portbench import grids, run
from portbench.drivers import common
from portbench.reference.interp import interp, magnitudes

CPU = torch.device("cpu")
DT = torch.float64
# the recipe's arguments (members_made_by): age 9.0, [Fe/H] 0, 300 pc with no
# scatter, AV 0.05, alpha -2, gamma 0.3, fB 0.3, masses 0.6-2.0, noise 0.02
AGE, FEH, DIST, AV, ALPHA, GAMMA, FB, MASSES, UNC = 9.0, 0.0, 300.0, 0.05, -2.0, 0.3, 0.3, (0.6, 2.0), 0.02
CONFIGS = ["cluster50-mist-f64", "cluster200-mist-f64-4card"]


def _config(name):
    bench = run.load_json("BENCHMARK.json")
    (cfg,) = [run.load_json(c["file"]) for c in bench["configs"] if c["name"] == name]
    return cfg


@functools.lru_cache(maxsize=1)
def _tables(n_feh, n_mass, n_eep, n_age, bands):
    values, knots = grids.iso_table(n_feh, n_mass, n_eep, n_age, CPU, DT)
    bc_values, bc_knots = grids.bc_table(bands, CPU, DT)
    as_t = lambda ks: tuple(torch.as_tensor(k, dtype=DT) for k in ks)  # noqa: E731
    return (values, as_t(knots), grids.ISO_COLUMNS), (bc_values, as_t(bc_knots), bands)


def _power_law(a, lo, hi, u):
    """Inverse of the CDF of p(x) ~ x**a on [lo, hi] at uniform ``u``."""
    return (lo ** (a + 1) + u * (hi ** (a + 1) - lo ** (a + 1))) ** (1 / (a + 1))


class _Plain:
    """The members' photometry from the reference on one grid."""

    def __init__(self, cfg):
        g = cfg["grid"]
        self.bands = tuple(cfg["bands"])
        self.iso, self.bc = _tables(g["n_feh"], g["n_mass"], g["n_eep"], g["n_age"], self.bands)
        eeps = torch.arange(1, g["n_eep"] + 1, dtype=DT)
        pts = torch.stack([torch.full_like(eeps, AGE), torch.full_like(eeps, FEH), eeps], dim=-1)
        mass = interp(self.iso[0], self.iso[1], pts, [grids.ISO_COLUMNS.index("initial_mass")])[..., 0].numpy()
        alive = np.isfinite(mass)
        self.eep_ladder, self.mass_ladder = eeps.numpy()[alive], mass[alive]
        assert np.all(np.diff(self.mass_ladder) > 0)

    def eep(self, mass):
        m = self.mass_ladder
        return np.where((mass >= m[0]) & (mass <= m[-1]), np.interp(mass, m, self.eep_ladder), np.nan)

    def mags(self, eep_pri, eep_sec, dist):
        def one(e):
            n = len(e)
            pts = torch.stack([torch.as_tensor(e, dtype=DT), torch.full((n,), AGE, dtype=DT),
                               torch.full((n,), FEH, dtype=DT), torch.as_tensor(dist, dtype=DT),
                               torch.full((n,), AV, dtype=DT)], dim=-1)
            return magnitudes(self.iso, self.bc, pts, list(range(len(self.bands))))[3].numpy()

        binary = np.isfinite(eep_sec)
        mp, ms = one(eep_pri), one(np.where(binary, eep_sec, eep_pri))
        both = -2.5 * np.log10(10 ** (-0.4 * mp) + 10 ** (-0.4 * ms))
        return np.where(binary[:, None], both, mp)

    def draw(self, n):
        """The recipe's draws at ``n`` members and its redraws."""
        r = np.random.default_rng(0)

        def members(k):
            is_b = r.random(k) < FB
            pri = _power_law(ALPHA, *MASSES, r.random(k))
            sec = pri * _power_law(GAMMA, 0.2, 1.0, r.random(k)) * is_b
            sec[(sec < 0.1) & (sec > 0)] = 0.1
            return is_b, pri, sec, DIST + r.standard_normal(k) * 0.0

        is_b, pri, sec, dist = members(n)
        for _ in range(100):
            eep_pri = self.eep(pri)
            eep_sec = np.where(sec > 0, self.eep(np.maximum(sec, 1e-3)), np.nan)
            noise = np.stack([r.standard_normal(n) for _ in self.bands], axis=-1) * UNC
            bad = np.isnan(self.mags(eep_pri, eep_sec, dist)).any(axis=-1)
            if not bad.any():
                break
            is_b[bad], pri[bad], sec[bad], dist[bad] = members(int(bad.sum()))
        return is_b, pri, sec, dist, eep_pri, noise


@pytest.mark.parametrize("name", CONFIGS)
def test_members_are_drawn_again_by_plain_numpy_and_the_reference(name):
    cfg = _config(name)
    data = common.read_csv(cfg["members"])
    plain = _Plain(cfg)
    n = len(data["J_mag"])
    is_b, pri, sec, dist, eep_pri, noise = plain.draw(n)

    np.testing.assert_array_equal(data["is_binary"] > 0.5, is_b)
    np.testing.assert_allclose(data["mass_pri"], pri, rtol=1e-12, atol=0)
    np.testing.assert_allclose(data["mass_sec"], sec, rtol=1e-12, atol=0)
    np.testing.assert_allclose(data["distance"], dist, rtol=1e-12, atol=0)
    np.testing.assert_allclose(data["parallax"], 1000.0 / dist, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(np.isfinite(data["eep_sec"]), sec > 0)
    for b in plain.bands:
        np.testing.assert_array_equal(data[f"{b}_mag_unc"], UNC)

    obs = np.stack([data[f"{b}_mag"] for b in plain.bands], axis=-1)
    at_stored = plain.mags(data["eep_pri"], data["eep_sec"], dist) + noise
    np.testing.assert_allclose(obs, at_stored, rtol=0, atol=1e-9)

    eep_sec = np.where(sec > 0, plain.eep(np.maximum(sec, 1e-3)), np.nan)
    assert np.nanmax(np.abs(np.concatenate([eep_pri - data["eep_pri"], eep_sec - data["eep_sec"]]))) < 2.0
    assert np.abs(plain.mags(eep_pri, eep_sec, dist) + noise - obs).max() < UNC
