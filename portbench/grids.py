"""The synthetic MIST-shaped tables, built in torch on the run's device.

A frozen copy of the table arithmetic of ``isochrones_torch/grids/synthetic.py``
(``make_synthetic_grids``): the same knots (computed in float64 with numpy,
as there) and the same closed-form columns, but the column planes are
computed in torch on the device in a few large calls, so that set-up uploads
no table from the host. The benchmark hands these tensors to the program
through its public grid constructors and to the reference as they are, so
both sides read one set of tables. Only the isochrone grid (log10 age, [Fe/H],
EEP) and the bolometric-correction grid are built: neither cell uses the
evolution-track grid.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# physical constants of isochrones_torch/utils.py
G_CGS = 6.6743e-08
MSUN_CGS = 1.98840987069805e33
RSUN_CGS = 6.957e10

TEFF_SUN = 5772.0
NU_MAX_SUN = 3090.0
DELTA_NU_SUN = 135.1
LOG_T0 = 10.1

#: the isochrone grid's columns in their order; ``dm_deep`` is
#: d(initial_mass)/d(EEP) along each isochrone
ISO_COLUMNS = ("eep", "age", "feh", "mass", "initial_mass", "radius", "density", "logTeff", "Teff", "logg", "logL",
               "Mbol", "delta_nu", "nu_max", "dm_deep")

BAND_EXT = {"J": 0.28, "H": 0.18, "K": 0.12, "G": 0.86, "BP": 1.08, "RP": 0.65, "W1": 0.07, "W2": 0.05, "W3": 0.09,
            "TESS": 0.62, "Kepler": 0.85}
BAND_ZP = {"J": 1.2, "H": 1.45, "K": 1.55, "G": 0.1, "BP": -0.05, "RP": 0.45, "W1": 1.6, "W2": 1.65, "W3": 1.7,
           "TESS": 0.5, "Kepler": 0.15}


def knots(n_feh, n_mass, n_eep, n_age, eep_start=1):
    """The float64 numpy knots ``fehs, masses, eeps, ages``."""
    fehs = np.linspace(-2.0, 0.5, n_feh)
    masses = np.exp(np.linspace(np.log(0.1), np.log(10.0), n_mass))
    eeps = np.arange(eep_start, eep_start + n_eep, dtype=float)
    return fehs, masses, eeps, np.linspace(6.0, 10.1, n_age)


def bc_knots():
    """The BC grid's float64 numpy knots ``(Teff, logg, feh, AV)``."""
    return (np.concatenate([np.linspace(2000.0, 12000.0, 41), np.linspace(13000.0, 50000.0, 12)]),
            np.linspace(-1.0, 6.0, 15), np.linspace(-4.0, 1.0, 11), np.linspace(0.0, 6.0, 13))


def _max_eep(mass, feh, n_eep):
    frac = 0.62 + 0.38 / (1.0 + 0.5 * mass) + 0.02 * feh
    return torch.clamp(torch.floor(n_eep * torch.clamp(frac, 0.3, 1.0)), max=n_eep)


def _gradient_last(y, x):
    """``np.gradient(y, axis=-1) / np.gradient(x, axis=-1)``: central
    differences inside, one-sided at the two ends (unit spacing)."""
    def grad(a):
        out = torch.empty_like(a)
        out[..., 1:-1] = (a[..., 2:] - a[..., :-2]) / 2.0
        out[..., 0] = a[..., 1] - a[..., 0]
        out[..., -1] = a[..., -1] - a[..., -2]
        return out

    return grad(y) / grad(x)


def iso_table(n_feh, n_mass, n_eep, n_age, device, dtype=torch.float64, eep_start=1):
    """``(values (n_age, n_feh, n_eep, 15), (ages, fehs, eeps))``: the
    isochrone grid, NaN where no star lives, computed in float64 on
    ``device`` and returned in ``dtype``."""
    fehs, masses, eeps, ages = knots(n_feh, n_mass, n_eep, n_age, eep_start)
    f64 = dict(dtype=torch.float64, device=device)
    A = torch.as_tensor(ages, **f64)[:, None, None]
    F = torch.as_tensor(fehs, **f64)[None, :, None]
    E = torch.as_tensor(eeps, **f64)[None, None, :]
    A, F, E = torch.broadcast_tensors(A, F, E)
    top = eep_start + n_eep - 1
    eep_frac = E / top
    M = 10 ** ((LOG_T0 + 2.4 * torch.log10(torch.clamp(eep_frac, min=1e-6)) - A) / 2.6)
    valid = (M >= masses[0]) & (M <= masses[-1]) & (E <= _max_eep(M, F, top))

    lm = torch.log10(M)
    logL = 3.6 * lm + 1.4 * eep_frac ** 2 + 0.05 * F
    logTeff = math.log10(TEFF_SUN) + 0.18 * lm + 0.45 * lm * eep_frac ** 2 - 0.12 * eep_frac ** 3 - 0.015 * F
    radius = 10 ** (0.5 * logL - 2.0 * (logTeff - math.log10(TEFF_SUN)))
    logg = torch.log10(G_CGS * M * MSUN_CGS / (radius * RSUN_CGS) ** 2)
    Teff = 10 ** logTeff
    density = M * MSUN_CGS / (4.0 / 3.0 * math.pi * (radius * RSUN_CGS) ** 3)
    nu_max = NU_MAX_SUN * (10 ** logg / 10 ** 4.438) / torch.sqrt(Teff / TEFF_SUN)
    delta_nu = DELTA_NU_SUN * torch.sqrt(M / radius ** 3)
    cols = dict(eep=E, age=A, feh=F, mass=M, initial_mass=M, radius=radius, density=density, logTeff=logTeff,
                Teff=Teff, logg=logg, logL=logL, Mbol=4.74 - 2.5 * logL, delta_nu=delta_nu, nu_max=nu_max,
                dm_deep=_gradient_last(M, E))
    nan = torch.tensor(float("nan"), **f64)
    values = torch.stack([torch.where(valid, cols[c], nan) for c in ISO_COLUMNS], dim=-1)
    return values.to(dtype).contiguous(), (ages, fehs, eeps)


def bc_table(bands, device, dtype=torch.float64):
    """``(values (53, 15, 11, 13, n_bands), knots)``: the bolometric
    corrections of ``bands`` at (Teff, logg, [Fe/H], AV)."""
    kn = bc_knots()
    f64 = dict(dtype=torch.float64, device=device)
    T, G, Fb, Av = torch.meshgrid(*(torch.as_tensor(k, **f64) for k in kn), indexing="ij")
    x = torch.log10(T) - 3.77
    values = torch.stack([BAND_ZP[b] - 3.2 * x ** 2 + 0.45 * x - 0.04 * (G - 4.4) + 0.06 * Fb - BAND_EXT[b] * Av
                          for b in bands], dim=-1)
    return values.to(dtype).contiguous(), kn
