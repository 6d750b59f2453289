"""What the drivers share: the kernels' build, the tables handed to both
sides, the members' CSV and the check's arithmetic."""

from __future__ import annotations

import csv
import os
import time

import numpy as np
import torch

from .. import grids
from .. import ROOT


def build_kernels(device):
    """Compile the program's CUDA library unless its checkout holds it
    already; the seconds the compile took (0 when it was built)."""
    if device.type != "cuda":
        return 0.0
    from isochrones_torch.ops._build import build

    t0 = time.perf_counter()
    _, seconds, _ = build()
    return time.perf_counter() - t0 if seconds else 0.0


def interpolator(cfg, device):
    """``(ic, tables)``: the program's isochrone interpolator on the tables
    of ``cfg["grid"]``, built on ``device`` in ``cfg["dtype"]``, and the same
    tensors for the reference (``iso`` and ``bc`` as ``(values, knots,
    columns)``, ``band_cols`` the BC columns of the configuration's bands)."""
    from isochrones_torch.models import IsochroneInterpolator
    from isochrones_torch.ops.interp import GridData, compute_axis_maps

    g = cfg["grid"]
    dtype = getattr(torch, cfg["dtype"])
    bands = tuple(cfg["bands"])
    values, iso_knots = grids.iso_table(g["n_feh"], g["n_mass"], g["n_eep"], g["n_age"], device, dtype)
    bc_values, bc_knots = grids.bc_table(bands, device, dtype)

    def grid(vals, knots, columns):
        return GridData(values=vals, knots=tuple(torch.as_tensor(k, dtype=dtype, device=device) for k in knots),
                        columns=tuple(columns), axis_maps=compute_axis_maps(knots))

    iso, bc = grid(values, iso_knots, grids.ISO_COLUMNS), grid(bc_values, bc_knots, bands)
    ic = IsochroneInterpolator(iso, bc, bands=list(bands))
    tables = {"iso": (iso.values, iso.knots, grids.ISO_COLUMNS), "bc": (bc.values, bc.knots, bands),
              "band_cols": list(range(len(bands)))}
    return ic, tables


def as_dtype(tables, dtype):
    """The reference's tables in another dtype."""
    def cast(t):
        values, knots, columns = t
        return values.to(dtype), tuple(k.to(dtype) for k in knots), columns

    return {"iso": cast(tables["iso"]), "bc": cast(tables["bc"]), "band_cols": tables["band_cols"]}


def read_csv(rel):
    """A numeric CSV under the checkout -> dict of float64 columns (an empty
    cell is NaN)."""
    with open(os.path.join(ROOT, rel), newline="") as f:
        rows = list(csv.reader(f))
    return {name: np.array([float(r[i]) if r[i] else np.nan for r in rows[1:]]) for i, name in enumerate(rows[0])}


def gaps(prog, ref):
    """``(worst gap, finite mismatches)``: the largest ``|prog - ref| /
    max(1, |ref|)`` where both are finite, and the count of entries finite
    on one side only."""
    prog, ref = np.asarray(prog, dtype=float), np.asarray(ref, dtype=float)
    fp, fr = np.isfinite(prog), np.isfinite(ref)
    both = fp & fr
    gap = np.abs(prog[both] - ref[both]) / np.maximum(1.0, np.abs(ref[both]))
    return (float(gap.max()) if gap.size else 0.0), int((fp != fr).sum())


def seeded(seed, *salt):
    """A numpy Generator from the run's seed and a tag."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2 ** 64, *salt]))
