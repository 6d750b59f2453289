"""Write a tree of MIST-format files from the synthetic physics.

The ``.track.eep``, ``.iso`` and BC tables come out in the layouts of the
MIST distribution (headers, file and directory names, comment lines), filled
with the analytic stellar model of :mod:`isochrones_torch.grids.synthetic`, so
that :func:`~isochrones_torch.isochrone.get_ichrone` ``("mist")`` can be run
where no MIST file is at hand. The files are those of the JAX package's test
fixtures (``tests/mist_fixtures.py``) at its sizes, byte for byte, but for
the BC columns of bands outside the synthetic tables: their coefficients come
from a stable digest of the band's name (CRC-32) instead of Python's
per-process ``hash``. Each file is computed with numpy a column at a time.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

from .synthetic import _BAND_EXT, _BAND_ZP, _bc_value, _log_age, _mass_from_age, _stellar_props

__all__ = ["make_track_tree", "make_iso_tree", "make_bc_tree", "make_full_mist_tree", "write_track_file",
           "write_iso_file", "bc_value", "TRACK_COLUMNS", "ISO_COLUMNS"]

TRACK_COLUMNS = (
    "star_age", "star_mass", "log_Teff", "log_g", "log_L", "log_R",
    "log_surf_z", "surface_h1", "delta_nu", "nu_max", "phase",
)
ISO_COLUMNS = (
    "EEP", "log10_isochrone_age_yr", "initial_mass", "star_mass", "log_Teff",
    "log_g", "log_L", "log_R", "log_surf_z", "surface_h1", "delta_nu",
    "nu_max", "phase",
)

SURFACE_H1 = 0.7
Z_SUN = 0.0181

#: the BC axes of the test fixtures
BC_TEFFS = (3000.0, 4500.0, 6000.0, 8000.0, 12000.0)
BC_LOGGS = (1.0, 3.0, 5.0)
BC_AVS = (0.0, 1.0, 3.0)


def _surf_z(feh):
    # invert feh = log_surf_z - log10(surface_h1) - log10(0.0181)
    return 10 ** (feh + np.log10(SURFACE_H1) + np.log10(Z_SUN))


def _columns(mass, feh, eep, n_eep_total):
    """The track columns at the EEPs ``eep`` (an integer array) of one star."""
    frac = eep / n_eep_total
    p = _stellar_props(mass, feh, frac)
    n = len(eep)
    return dict(
        star_age=10 ** _log_age(mass, frac),
        star_mass=np.broadcast_to(np.asarray(mass, dtype=float), (n,)),
        log_Teff=p["logTeff"],
        log_g=p["logg"],
        log_L=p["logL"],
        log_R=np.log10(p["radius"]),
        log_surf_z=np.full(n, np.log10(_surf_z(feh))),
        surface_h1=np.full(n, SURFACE_H1),
        delta_nu=p["delta_nu"],
        nu_max=p["nu_max"],
        phase=np.zeros(n),
    )


def _rows(cols, names):
    """The text of the rows: each value as ``%.8g``, space separated."""
    fmt = " ".join(["%.8g"] * len(names)) + "\n"
    return "".join(fmt % row for row in zip(*(np.asarray(cols[c]).tolist() for c in names)))


def write_track_file(directory, mass, feh, n_rows, n_eep_total=1710):
    """One ``XXXXXM.track.eep`` file with MIST's header lines."""
    fn = os.path.join(directory, "{:05.0f}M.track.eep".format(mass * 100))
    eep = np.arange(1, n_rows + 1)
    with open(fn, "w") as f:
        f.write("# MIST-format synthetic track (test fixture)\n")
        f.write("# EEPs: " + " ".join(str(i) for i in range(1, n_rows + 1)) + "\n")
        f.write("#  " + " ".join(TRACK_COLUMNS) + "\n")
        f.write(_rows(_columns(mass, feh, eep, n_eep_total), TRACK_COLUMNS))
    return fn


def make_track_tree(root, fehs=(-0.5, 0.0), masses=(0.7, 0.8, 0.9), short={}, n_eep=60, version="1.2", vvcrit=0.4,
                    afe=0.0):
    """The tracks' directory tree of ``MISTEvolutionTrackGrid`` under ``root``.

    short : ``{(feh, mass): n_rows}`` for tracks of another length than
        ``n_eep`` (incomplete ones, or each track's own length)
    """
    datadir = os.path.join(root, "mist", "tracks")
    for feh in fehs:
        fs = "m" if feh < 0 else "p"
        basename = f"MIST_v{version}_feh_{fs}{abs(feh):.2f}_afe_p{abs(afe):.1f}_vvcrit{vvcrit:.1f}_EEPS"
        d = os.path.join(datadir, basename)
        os.makedirs(d, exist_ok=True)
        for m in masses:
            write_track_file(d, m, feh, short.get((feh, m), n_eep), n_eep_total=n_eep)
    return datadir


def write_iso_file(directory, feh, ages, masses, n_eep=60, version="1.2", vvcrit=0.4):
    """One ``.iso`` file: an isochrone per age, its EEPs whose initial mass
    lies in ``[masses[0], masses[-1]]``, stacked under one header."""
    fs = "m" if feh < 0 else "p"
    fn = os.path.join(directory, f"MIST_v{version}_feh_{fs}{abs(feh):.2f}_afe_p0.0_vvcrit{vvcrit:.1f}_full.iso")
    eep = np.arange(1, n_eep + 1)
    with open(fn, "w") as f:
        f.write("# MIST-format synthetic isochrones (test fixture)\n")
        f.write("# " + " ".join(ISO_COLUMNS) + "\n")
        for age in ages:
            mass = _mass_from_age(age, eep / n_eep)
            keep = (masses[0] <= mass) & (mass <= masses[-1])
            cols = _columns(mass[keep], feh, eep[keep], n_eep)
            cols.update(EEP=eep[keep], log10_isochrone_age_yr=np.full(int(keep.sum()), age), initial_mass=mass[keep])
            f.write(_rows(cols, ISO_COLUMNS))
    return fn


def make_iso_tree(root, fehs=(-0.5, 0.0), ages=(8.0, 8.5, 9.0), masses=(0.3, 3.0), n_eep=60, version="1.2",
                  vvcrit=0.4, kind="full_isos"):
    """The isochrones' directory of ``MISTIsochroneGrid`` under ``root``."""
    d = os.path.join(root, "mist", f"MIST_v{version}_vvcrit{vvcrit}_{kind}")
    os.makedirs(d, exist_ok=True)
    for feh in fehs:
        write_iso_file(d, feh, ages, masses, n_eep=n_eep, version=version, vvcrit=vvcrit)
    return d


def bc_value(band, logTeff, logg, feh, AV):
    """Toy BC of a MIST band name: the synthetic table's value where the
    name's last part is one of its bands, else coefficients drawn from the
    CRC-32 of the name."""
    short = band.split("_")[-1] if "_" in band else band
    if short in _BAND_ZP:
        return _bc_value(short, logTeff, logg, feh, AV)
    h = (zlib.crc32(band.encode()) % 1000) / 1000.0
    zp = (h - 0.5) * 2.0
    ext = 0.1 + h
    x = logTeff - 3.77
    return zp - 3.2 * x ** 2 + 0.45 * x - 0.04 * (logg - 4.4) + 0.06 * feh - ext * AV


def make_bc_tree(root, systems=("UBVRIplus", "WISE"), fehs=(-0.5, 0.0), teffs=BC_TEFFS, loggs=BC_LOGGS,
                 avs=BC_AVS):
    """BC tables, one file per (system, [Fe/H]) in MIST's layout: five
    comment lines, the column names on the sixth, then the whole (Teff,
    logg, Av) product at Rv = 3.1."""
    from .mist import MISTBolometricCorrectionGrid

    rv = 3.1
    datadir = os.path.join(root, "BC", "mist")
    os.makedirs(datadir, exist_ok=True)
    T, G, A = (a.ravel() for a in np.meshgrid(np.asarray(teffs, dtype=float), np.asarray(loggs, dtype=float),
                                              np.asarray(avs, dtype=float), indexing="ij"))
    for phot in systems:
        bands = MISTBolometricCorrectionGrid.phot_bands[phot]
        for feh in fehs:
            fs = "m" if feh < 0 else "p"
            fn = os.path.join(datadir, "feh{0}{1:03.0f}.{2}".format(fs, abs(feh) * 100, phot))
            vals = [np.asarray(bc_value(b, np.log10(T), G, feh, A), dtype=float).tolist() for b in bands]
            head = [f"{t:.1f} {g:.2f} {feh:.2f} {a:.2f} {rv:.1f} " for t, g, a in zip(T.tolist(), G.tolist(),
                                                                                   A.tolist())]
            fmt = " ".join(["%.6f"] * len(bands)) + "\n"
            with open(fn, "w") as f:
                for _ in range(5):
                    f.write("# synthetic MIST BC table (test fixture)\n")
                f.write("# Teff logg [Fe/H] Av Rv " + " ".join(bands) + "\n")
                f.write("".join(h + fmt % row for h, row in zip(head, zip(*vals))))
    return datadir


def make_full_mist_tree(root, track_kwargs=None, iso_kwargs=None, bc_kwargs=None):
    """Tracks, isochrones and BC tables under ``root``, as
    ``tests/mist_fixtures.make_full_mist_fixture`` lays them out."""
    track_kwargs = dict(dict(short={(0.0, 0.8): 40}), **(track_kwargs or {}))
    make_track_tree(root, **track_kwargs)
    make_iso_tree(root, **(iso_kwargs or {}))
    make_bc_tree(root, **(bc_kwargs or {}))
    return root
