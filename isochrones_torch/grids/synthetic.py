"""Synthetic MIST-like stellar model + bolometric-correction grids.

Counterpart of ``isochrones_tpu/grids/synthetic.py``: the same numpy code
builds the same arrays bit for bit in float64; the tables are then uploaded
to ``device`` in ``dtype`` as :class:`~isochrones_torch.ops.interp.GridData`.

* evolution-track grid indexed (feh, initial_mass, eep),
* isochrone grid indexed (log10_age, feh, eep),
* BC grid indexed (Teff, logg, feh, AV).

For MIST-scale runs use ``n_feh=15, n_mass=196, n_eep=1710, n_age=107``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..convert import grid_from_numpy
from ..ops.interp import GridData
from ..utils import G_CGS, MSUN_CGS, RSUN_CGS

__all__ = ["SyntheticStellarGrids", "make_synthetic_grids", "DEFAULT_BANDS", "STANDARD_COLUMNS"]

# Default bands mirror the reference's (mist/bc.py:159): 2MASS JHK, Gaia, WISE,
# TESS, Kepler.
DEFAULT_BANDS = ("J", "H", "K", "G", "BP", "RP", "W1", "W2", "W3", "TESS", "Kepler")

# Standard model-grid column schema (reference default_columns, models.py:28-41)
# + dt_deep/dm_deep derivative columns used by the EEP change-of-variables prior.
STANDARD_COLUMNS = (
    "eep",
    "age",
    "feh",
    "mass",
    "initial_mass",
    "radius",
    "density",
    "logTeff",
    "Teff",
    "logg",
    "logL",
    "Mbol",
    "delta_nu",
    "nu_max",
    "dt_deep",
)

# toy extinction coefficients A_band / AV (descending with wavelength)
_BAND_EXT = {
    "J": 0.28,
    "H": 0.18,
    "K": 0.12,
    "G": 0.86,
    "BP": 1.08,
    "RP": 0.65,
    "W1": 0.07,
    "W2": 0.05,
    "W3": 0.09,
    "TESS": 0.62,
    "Kepler": 0.85,
    "U": 1.56,
    "B": 1.32,
    "V": 1.0,
    "g": 1.20,
    "r": 0.88,
    "i": 0.68,
    "z": 0.52,
}
# toy band zero-point offsets
_BAND_ZP = {
    "J": 1.2,
    "H": 1.45,
    "K": 1.55,
    "G": 0.1,
    "BP": -0.05,
    "RP": 0.45,
    "W1": 1.6,
    "W2": 1.65,
    "W3": 1.7,
    "TESS": 0.5,
    "Kepler": 0.15,
    "U": -0.6,
    "B": -0.25,
    "V": 0.0,
    "g": -0.15,
    "r": 0.1,
    "i": 0.3,
    "z": 0.4,
}

TEFF_SUN = 5772.0
NU_MAX_SUN = 3090.0  # muHz
DELTA_NU_SUN = 135.1  # muHz
LOG_T0 = 10.1  # log10(yr): toy main-sequence lifetime of a 1 Msun star


def _max_eep(mass, feh, n_eep):
    """Toy analog of the MIST truncation map (mist/eep.py:1-59): higher-mass
    (and lower-feh) tracks end at smaller EEP."""
    frac = 0.62 + 0.38 / (1.0 + 0.5 * np.asarray(mass)) + 0.02 * np.asarray(feh)
    out = np.floor(n_eep * np.clip(frac, 0.3, 1.0)).astype(int)
    return np.minimum(out, n_eep)


def _log_age(mass, eep_frac):
    """Strictly increasing log10(age/yr) along each track."""
    return LOG_T0 - 2.6 * np.log10(mass) + 2.4 * np.log10(np.maximum(eep_frac, 1e-6))


def _mass_from_age(log_age, eep_frac):
    """Exact inverse of :func:`_log_age` for the isochrone grid."""
    return 10 ** ((LOG_T0 + 2.4 * np.log10(np.maximum(eep_frac, 1e-6)) - log_age) / 2.6)


def _stellar_props(mass, feh, eep_frac):
    """Toy consistent stellar structure as a function of (mass, feh, phase)."""
    phase = eep_frac
    logL = 3.6 * np.log10(mass) + 1.4 * phase ** 2 + 0.05 * feh
    logTeff = (
        np.log10(TEFF_SUN)
        + 0.18 * np.log10(mass)
        + 0.45 * np.log10(mass) * phase ** 2  # hotter stars evolve blueward-then-red
        - 0.12 * phase ** 3
        - 0.015 * feh
    )
    # Stefan-Boltzmann: R/Rsun = sqrt(L/Lsun) (Teff/Tsun)^-2
    log_radius = 0.5 * logL - 2.0 * (logTeff - np.log10(TEFF_SUN))
    radius = 10 ** log_radius
    logg = np.log10(G_CGS * mass * MSUN_CGS / (radius * RSUN_CGS) ** 2)
    Teff = 10 ** logTeff
    Mbol = 4.74 - 2.5 * logL
    density = mass * MSUN_CGS / (4.0 / 3.0 * np.pi * (radius * RSUN_CGS) ** 3)
    # scaling relations (Kjeldsen & Bedding): nu_max ~ g/sqrt(Teff), delta_nu ~ sqrt(rho)
    nu_max = NU_MAX_SUN * (10 ** logg / 10 ** 4.438) / np.sqrt(Teff / TEFF_SUN)
    delta_nu = DELTA_NU_SUN * np.sqrt(mass / radius ** 3)
    return dict(
        logL=logL,
        logTeff=logTeff,
        Teff=Teff,
        radius=radius,
        logg=logg,
        Mbol=Mbol,
        density=density,
        nu_max=nu_max,
        delta_nu=delta_nu,
    )


def _bc_value(band, logTeff, logg, feh, AV):
    """Smooth toy bolometric correction per band (linear in AV)."""
    x = logTeff - 3.77
    zp = _BAND_ZP[band]
    ext = _BAND_EXT[band]
    return zp - 3.2 * x ** 2 + 0.45 * x - 0.04 * (logg - 4.4) + 0.06 * feh - ext * AV


@dataclasses.dataclass
class SyntheticStellarGrids:
    """Bundle of synthetic grids in both track and isochrone parameterization."""

    track: GridData  # (feh, mass, eep) -> columns
    iso: GridData  # (log10_age, feh, eep) -> columns
    bc: GridData  # (Teff, logg, feh, AV) -> bands
    # EEP-inversion support arrays (reference get_array_grids, models.py:171-205):
    age_arrays: np.ndarray  # (n_feh * n_mass, n_eep), +inf padded past track end
    dt_deep_arrays: np.ndarray  # (n_feh * n_mass, n_eep), NaN padded
    lengths: np.ndarray  # (n_feh * n_mass,) int32
    fehs: np.ndarray
    masses: np.ndarray
    eeps: np.ndarray
    ages: np.ndarray
    bands: Tuple[str, ...]

    def astype(self, dtype):
        """The bundle in the torch ``dtype``: the three tables and the EEP
        support arrays with them (``lengths`` stays integer), so a float32
        bundle never promotes the EEP inversion back to float64."""
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        return dataclasses.replace(
            self, track=self.track.astype(dtype), iso=self.iso.astype(dtype), bc=self.bc.astype(dtype),
            **{k: np.asarray(getattr(self, k), dtype=np_dtype)
               for k in ("age_arrays", "dt_deep_arrays", "fehs", "masses", "eeps", "ages")})


def make_synthetic_grids(
    n_feh: int = 9,
    n_mass: int = 48,
    n_eep: int = 200,
    n_age: int = 40,
    bands: Sequence[str] = DEFAULT_BANDS,
    eep_start: int = 1,
    device="cuda",
    dtype=torch.float64,
) -> SyntheticStellarGrids:
    """Build the full synthetic grid bundle in float64 on the host and upload
    its three tables to ``device`` (the card unless the caller passes
    ``device="cpu"``) in ``dtype``."""
    fehs = np.linspace(-2.0, 0.5, n_feh)
    masses = np.exp(np.linspace(np.log(0.1), np.log(10.0), n_mass))
    eeps = np.arange(eep_start, eep_start + n_eep, dtype=float)

    # ---- track grid: (feh, mass, eep) ----
    F, M, E = np.meshgrid(fehs, masses, eeps, indexing="ij")
    maxeep = _max_eep(M, F, eep_start + n_eep - 1)
    eep_frac = E / (eep_start + n_eep - 1)
    valid = E <= maxeep

    log_age = _log_age(M, eep_frac)
    props = _stellar_props(M, F, eep_frac)

    cols = {}
    cols["eep"] = E
    cols["age"] = log_age
    cols["feh"] = F + 0.0  # surface feh == initial feh in the toy model
    cols["mass"] = M + 0.0
    cols["initial_mass"] = M + 0.0
    cols["radius"] = props["radius"]
    cols["density"] = props["density"]
    cols["logTeff"] = props["logTeff"]
    cols["Teff"] = props["Teff"]
    cols["logg"] = props["logg"]
    cols["logL"] = props["logL"]
    cols["Mbol"] = props["Mbol"]
    cols["delta_nu"] = props["delta_nu"]
    cols["nu_max"] = props["nu_max"]
    # dt_deep = d(age)/d(eep) along tracks (reference mist/models.py:403-435)
    cols["dt_deep"] = np.gradient(log_age, axis=-1) / np.gradient(E, axis=-1)

    track_vals = np.stack([np.where(valid, cols[c], np.nan) for c in STANDARD_COLUMNS], axis=-1)
    track = grid_from_numpy(track_vals, (fehs, masses, eeps), STANDARD_COLUMNS,
                            device=device, dtype=dtype)

    # ---- EEP-inversion arrays (+inf-padded monotone age matrices) ----
    age_mat = np.where(valid, log_age, np.inf).reshape(n_feh * n_mass, n_eep)
    dt_mat = np.where(valid, cols["dt_deep"], np.nan).reshape(n_feh * n_mass, n_eep)
    lengths = valid.sum(axis=-1).reshape(n_feh * n_mass).astype(np.int32)

    # ---- isochrone grid: (log10_age, feh, eep), mass from exact inversion ----
    ages = np.linspace(6.0, 10.1, n_age)
    A, F2, E2 = np.meshgrid(ages, fehs, eeps, indexing="ij")
    eep_frac2 = E2 / (eep_start + n_eep - 1)
    M2 = _mass_from_age(A, eep_frac2)
    in_grid = (M2 >= masses[0]) & (M2 <= masses[-1])
    maxeep2 = _max_eep(M2, F2, eep_start + n_eep - 1)
    valid2 = in_grid & (E2 <= maxeep2)

    props2 = _stellar_props(M2, F2, eep_frac2)
    icols = {}
    icols["eep"] = E2
    icols["age"] = A + 0.0
    icols["feh"] = F2 + 0.0
    icols["mass"] = M2
    icols["initial_mass"] = M2
    icols["radius"] = props2["radius"]
    icols["density"] = props2["density"]
    icols["logTeff"] = props2["logTeff"]
    icols["Teff"] = props2["Teff"]
    icols["logg"] = props2["logg"]
    icols["logL"] = props2["logL"]
    icols["Mbol"] = props2["Mbol"]
    icols["delta_nu"] = props2["delta_nu"]
    icols["nu_max"] = props2["nu_max"]
    # dm_deep = d(initial_mass)/d(eep) along each isochrone (models.py:126-153)
    dm = np.gradient(M2, axis=-1) / np.gradient(E2, axis=-1)
    icols["dt_deep"] = dm  # slot reused; iso grids carry dm_deep

    iso_columns = tuple(c if c != "dt_deep" else "dm_deep" for c in STANDARD_COLUMNS)
    iso_vals = np.stack(
        [np.where(valid2, icols[c], np.nan) for c in STANDARD_COLUMNS], axis=-1
    )
    iso = grid_from_numpy(iso_vals, (ages, fehs, eeps), iso_columns, device=device, dtype=dtype)

    # ---- BC grid: (Teff, logg, feh, AV) ----
    bc_teff = np.concatenate(
        [np.linspace(2000.0, 12000.0, 41), np.linspace(13000.0, 50000.0, 12)]
    )
    bc_logg = np.linspace(-1.0, 6.0, 15)
    bc_feh = np.linspace(-4.0, 1.0, 11)
    bc_av = np.linspace(0.0, 6.0, 13)
    T, G_, Fb, Av = np.meshgrid(bc_teff, bc_logg, bc_feh, bc_av, indexing="ij")
    bands = tuple(bands)
    bc_vals = np.stack(
        [_bc_value(b, np.log10(T), G_, Fb, Av) for b in bands], axis=-1
    )
    bc = grid_from_numpy(bc_vals, (bc_teff, bc_logg, bc_feh, bc_av), bands,
                         device=device, dtype=dtype)

    return SyntheticStellarGrids(
        track=track,
        iso=iso,
        bc=bc,
        age_arrays=age_mat,
        dt_deep_arrays=dt_mat,
        lengths=lengths,
        fehs=fehs,
        masses=masses,
        eeps=eeps,
        ages=ages,
        bands=bands,
    )
