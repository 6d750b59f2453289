"""Synthetic stellar populations (counterpart of
``isochrones_tpu/populations.py``): ``StarFormationHistory``,
``StarFormationHistoryGrid``, ``BinaryDistribution``, ``StarPopulation`` and
``deredden``.

The host draws come from one ``numpy.random.Generator`` in the JAX package's
order (primary masses, binary flags, mass ratios, ages, [Fe/H], distances,
extinctions), so one seed gives the same stars in both packages. Each draw
round is one stacked :meth:`generate_binary` call: one kernel launch on the
card per ``HOST_CHUNK`` rows. With ``exact_N`` one fixed overdraw of
``ceil(1.25 N) + 16`` rows is drawn, then more rounds of that size until N
rows are valid; the first N valid rows are kept. Tables are
:class:`~isochrones_torch.summary.Frame` objects.
"""

from __future__ import annotations

import re

import numpy as np

from .logger import getLogger
from .priors import ChabrierPrior, FehPrior, PowerLawPrior
from .summary import Frame

__all__ = ["StarFormationHistory", "StarFormationHistoryGrid", "BinaryDistribution", "StarPopulation", "deredden"]


def _generator(rng):
    return rng if isinstance(rng, np.random.Generator) else np.random.default_rng(rng)


class StarFormationHistory:
    """Star formation history as a distribution over age in Gyr, uniform on
    0-10 Gyr by default (reference populations.py:11-26)."""

    def __init__(self, dist=None):
        if dist is None:
            from scipy.stats import uniform

            dist = uniform(0, 10)
        self.dist = dist

    def sample_ages(self, N, rng=None):
        """``N`` log10 ages [yr]."""
        return np.log10(1e9 * self.dist.rvs(int(N), random_state=_generator(rng)))


class StarFormationHistoryGrid(StarFormationHistory):
    """Star formation history on time bins (reference populations.py:29-41)."""

    def __init__(self, t_grid, sfh_grid):
        self.t_grid = np.asarray(t_grid)
        self.sfh_grid = np.asarray(sfh_grid)

    def sample_ages(self, N, rng=None):
        cdf = self.sfh_grid.cumsum() / self.sfh_grid.sum()
        i_bin = np.digitize(_generator(rng).random(int(N)), cdf)
        return np.log10(1e9 * self.t_grid[i_bin])


class BinaryDistribution:
    """Initial mass function, binary fraction ``fB`` and mass-ratio
    distribution, a power law of index ``gamma`` on [0.2, 1] by default
    (reference populations.py:44-59)."""

    def __init__(self, imf, fB=0.4, gamma=0.3, mass_ratio_distribution=None):
        self.imf = imf
        self.fB = fB
        self.gamma = gamma
        if mass_ratio_distribution is None:
            mass_ratio_distribution = PowerLawPrior(self.gamma, bounds=(0.2, 1))
        self.mass_ratio_distribution = mass_ratio_distribution

    def sample(self, N, rng=None):
        """``(primary masses, secondary masses)``; a single star's secondary is 0."""
        rng = _generator(rng)
        primary_mass = self.imf.sample(int(N), rng=rng)
        is_binary = rng.random(int(N)) < self.fB
        q = self.mass_ratio_distribution.sample(int(N), rng=rng)
        return primary_mass, q * primary_mass * is_binary


class StarPopulation:
    """Population generator (reference populations.py:62-166): binaries
    from ``imf``, ``fB`` and ``gamma``, ages from ``sfh``, [Fe/H] from
    ``feh``; ``distance`` and ``AV`` are priors to draw from or fixed values."""

    def __init__(self, ic, imf=None, fB=0.4, gamma=0.3, sfh=None, feh=None, mass_ratio_distribution=None,
                 distance=10.0, AV=0.0):
        self._ic = ic
        self.sfh = sfh if sfh is not None else StarFormationHistory()
        self.imf = imf if imf is not None else ChabrierPrior()
        self.fB = fB
        self.gamma = gamma
        self.binary_distribution = BinaryDistribution(self.imf, fB=fB, gamma=gamma,
                                                      mass_ratio_distribution=mass_ratio_distribution)
        self.feh = feh if feh is not None else FehPrior()
        self.distance = distance
        self.AV = AV

    @property
    def ic(self):
        return self._ic

    def _draw(self, N, rng, accurate, **kwargs):
        """One round: ``N`` drawn systems through ``generate_binary`` (rows
        off the grid included)."""
        masses, secondary = self.binary_distribution.sample(N, rng=rng)
        ages = self.sfh.sample_ages(N, rng=rng)
        fehs = self.feh.sample(N, rng=rng)
        distances = self.distance.sample(N, rng=rng) if hasattr(self.distance, "sample") else self.distance
        AVs = self.AV.sample(N, rng=rng) if hasattr(self.AV, "sample") else self.AV
        return self.ic.generate_binary(masses, secondary, ages, fehs, distance=distances, AV=AVs, all_As=True,
                                       accurate=accurate, **kwargs)

    def generate(self, N, accurate=False, exact_N=True, rng=None, max_rounds=100, **kwargs):
        """``N`` stars as a :class:`Frame`. With ``exact_N``, draw rounds of
        ``ceil(1.25 N) + 16`` systems until ``N`` rows have a primary on the
        grid and keep the first ``N`` (labelled ``0 .. N-1``); after
        ``max_rounds`` extra rounds the rest is NaN rows and a warning is
        logged. Without it, one round of ``N`` with the off-grid rows dropped
        (reference populations.py:97-166)."""
        N = int(N)
        rng = _generator(rng)
        if not exact_N:
            return self._draw(N, rng, accurate, **kwargs).dropna(subset=["mass_0"])

        M = int(np.ceil(N * 1.25)) + 16
        population = self._draw(M, rng, accurate, **kwargs).dropna(subset=["mass_0"])
        rounds = 0
        while len(population["mass_0"]) < N and rounds < max_rounds:
            new_pop = self._draw(M, rng, accurate, **kwargs).dropna(subset=["mass_0"])
            population = Frame.concat([population, new_pop])
            rounds += 1
        n_valid = len(population["mass_0"])
        if n_valid < N:
            getLogger().warning(
                "StarPopulation.generate(exact_N=True): only %d/%d valid rows after %d redraw rounds; the sampled "
                "parameter ranges barely meet the grid, and the frame is padded with NaN rows.",
                n_valid, N, max_rounds)
            pad = Frame({c: np.full(N - n_valid, np.nan) for c in population})
            population = Frame.concat([population, pad])
        return Frame(population.iloc[:N])


def deredden(pop, accurate=False, **kwargs):
    """The population at AV = 0, from its stored extinctions ``A_{band}``
    (reference populations.py:169-199)."""
    new_pop = pop.copy()
    bands = [m.group(1) for c in pop.columns if (m := re.search(r"^(\w+)_mag$", c))]
    n = len(new_pop["AV_0"])
    new_pop["AV_0"] = np.zeros(n)
    new_pop["AV_1"] = np.zeros(n)
    for b in bands:
        new_pop[f"{b}_mag"] = new_pop[f"{b}_mag"] - new_pop[f"A_{b}"]
        new_pop[f"{b}_mag_0"] = new_pop[f"{b}_mag_0"] - new_pop[f"A_{b}_0"]
        new_pop[f"{b}_mag_1"] = new_pop[f"{b}_mag_1"] - new_pop[f"A_{b}_1"]
        new_pop[f"A_{b}"] = np.zeros(n)
        new_pop[f"A_{b}_0"] = np.zeros(n)
        new_pop[f"A_{b}_1"] = np.zeros(n)
    return new_pop
