"""Folder-based starfit orchestration (counterpart of
``isochrones_tpu/starfit.py``).

Workflow: a folder containing ``star.ini`` -> model construction per
multiplicity -> fit on the device -> results file, with freshness checks.
The results file is the ``.npz`` container of
:meth:`~isochrones_torch.starmodel.BasicStarModel.save_hdf`,
``<models>_starmodel_<multiplicity>.npz``; the corner plots are PNGs beside
it. ``gaia=True`` conditions the fit on the closest Gaia source
(:func:`get_gaia_data`, through the query layer).
"""

from __future__ import annotations

import os
import time
import zipfile

import numpy as np
import torch

from .logger import initLogging

__all__ = ["starfit", "batch_starfit_script", "get_gaia_data", "update_ini_with_gaia"]

NSTARS = {"single": 1, "binary": 2, "triple": 3}


def get_gaia_data(ra, dec, radius=5.0, brightest=False):
    """The closest (or brightest) Gaia source's parallax and photometry at
    ``(ra, dec)``: ``{"parallax": (plx_mas, unc), "G": (mag, unc), ...}``
    (the role of the reference's tgastars integration, scripts/starfit:28-60,
    through the query layer)."""
    from .query import Gaia, Query

    cat = Gaia(Query(float(ra), float(dec), radius=float(radius)))
    row = cat.brightest if brightest else cat.closest
    data = {"parallax": (float(row["Plx"]), float(row["e_Plx"]))}
    data.update(cat.get_photometry(brightest=brightest))
    return data


def update_ini_with_gaia(ini_path, data):
    """Write Gaia-derived observables into ``star.ini``: top-level parallax
    (replacing any existing one) plus a ``[gaia]`` photometry section."""
    with open(ini_path) as fh:
        lines = fh.read().splitlines()
    out, in_gaia, seen_section = [], False, False
    for ln in lines:
        s = ln.strip()
        if s.startswith("["):
            seen_section = True
            in_gaia = s.lower() == "[gaia]"
            if in_gaia:
                continue
        if in_gaia:
            continue
        if not seen_section and s.lower().startswith("parallax"):
            continue
        out.append(ln)
    while out and not out[-1].strip():
        out.pop()
    plx, e_plx = data["parallax"]
    insert_at = next((i for i, ln in enumerate(out) if ln.strip().startswith("[")), len(out))
    out.insert(insert_at, f"parallax = {plx}, {e_plx}")
    phot = {k: v for k, v in data.items() if k != "parallax"}
    if phot:
        out.append("")
        out.append("[gaia]")
        for band, (mag, unc) in phot.items():
            out.append(f"{band} = {mag}, {unc}")
    with open(ini_path, "w") as f:
        f.write("\n".join(out) + "\n")


def _ini_native_bands(ini_path):
    """Bands an ini measured on its own. An existing ``[gaia]`` section (left
    by an earlier ``update_ini_with_gaia``) is excluded."""
    from .iniparse import IniSection, parse_ini
    from .treemodel import StarModel

    bands = []
    c = parse_ini(ini_path)
    for kw, v in c.items():
        if isinstance(v, IniSection):
            if kw.lower() == "gaia":
                continue
            for kw2 in v:
                b = StarModel._parse_band(kw2)
                if b is not None:
                    bands.append(b)
        else:
            b = StarModel._parse_band(kw)
            if b is not None:
                bands.append(b)
    return list(set(bands))


def _ini_radec(ini_path):
    from .iniparse import parse_ini, parse_value

    c = parse_ini(ini_path)
    ra = dec = None
    for k, v in c.items():
        if k in ("RA", "ra"):
            ra = parse_value(v)
        elif k in ("dec", "Dec"):
            dec = parse_value(v)
    if ra is None or dec is None:
        raise ValueError(f"gaia mode needs RA/dec in {ini_path}")
    return float(ra), float(dec)


def _flat_obs_kwargs(ini_path):
    """The flat model's observation keywords from an ini file (reference
    starfit.py, flat-model path): every ``name = value, uncertainty`` pair,
    top level or in a section, plus ``ra``, ``dec`` and ``maxAV``."""
    from .iniparse import IniSection, parse_ini, parse_value

    obs_kwargs = {}
    for k, v in parse_ini(ini_path).items():
        if isinstance(v, IniSection):
            for k2, v2 in v.items():
                val = parse_value(v2)
                if isinstance(val, list) and len(val) == 2:
                    obs_kwargs[k2] = tuple(val)
        else:
            val = parse_value(v)
            if isinstance(val, list) and len(val) == 2:
                obs_kwargs[k] = tuple(val)
            elif k in ("RA", "ra"):
                obs_kwargs["ra"] = val
            elif k in ("dec", "Dec"):
                obs_kwargs["dec"] = val
            elif k == "maxAV":
                obs_kwargs["maxAV"] = val
    return obs_kwargs


def starfit(
    folder,
    multiplicities=("single",),
    models="mist",
    feh_prior="local",
    use_emcee=False,
    plot_only=False,
    overwrite=False,
    verbose=False,
    logger=None,
    starmodel_type=None,
    ini_file="star.ini",
    no_plots=False,
    bands=None,
    gaia=False,
    write_ini_file=False,
    rootdir=None,
    gaia_radius=5.0,
    failures=None,
    device="cuda",
    dtype=torch.float64,
    **kwargs,
):
    """Run the starfit routine for a folder (reference starfit.py:18-161).

    feh_prior : 'flat' or 'local'
    gaia : condition the fit on the closest Gaia source's parallax (and its
        photometry, on the flat model) queried at the ini file's RA/dec
        (:func:`get_gaia_data`; ``query.Gaia.table_provider`` or astroquery).
        Where the grid lacks Gaia's bands, on the parallax alone.
    write_ini_file : with ``gaia``, write the queried values into the ini
        file (the tree model reads its Gaia photometry only from there).
    rootdir : resolve ``folder`` relative to this directory.
    failures : optional list; each failed (folder, multiplicity) fit is
        appended after being logged, so batch callers can exit nonzero.
        A checkpoint configuration mismatch (``resume`` against a checkpoint
        written for other data or settings) is re-raised, never swallowed
        into the log.
    device, dtype : where and in which type the model grids are built (the
        CUDA card unless the caller asks for ``"cpu"``; torch raises without
        one).
    no_plots : skip the corner plots. Otherwise
        ``<models>_corner_<multiplicity>_{physical,observed}.png`` are drawn
        where they are missing or older than the results file, or always with
        ``plot_only`` (which reloads the results file and fits nothing).
        Without matplotlib the plots fail as any step does: logged, the folder
        in ``failures``, the results file kept.

    Returns ``(model, logger)``; the results file is
    ``<folder>/<models>_starmodel_<multiplicity>.npz``.
    """
    from .priors import FlatPrior
    from .samplers.nested import CheckpointConfigError
    from .starmodel import BasicStarModel
    from .treemodel import StarModel

    if rootdir is not None:
        folder = os.path.join(rootdir, folder)

    Mod = BasicStarModel if starmodel_type is None else starmodel_type
    ichrone = None
    mod = None
    gaia_data = None
    native_ini_bands = None

    for mult in multiplicities:
        model_filename = f"{models}_starmodel_{mult}.npz"
        logfile = os.path.join(folder, "starfit.log")
        logger = initLogging(logfile, logger)
        name = os.path.basename(os.path.abspath(folder))

        try:
            start = time.time()
            model_path = os.path.join(folder, model_filename)
            if plot_only:
                mod = Mod.load_hdf(model_path, name=name, device=device, dtype=dtype)
            else:
                fit_model = True
                if os.path.exists(model_path):
                    try:
                        mod = Mod.load_hdf(model_path, name=name, device=device, dtype=dtype)
                        fit_model = False
                    except (KeyError, ValueError, OSError, zipfile.BadZipFile):
                        os.remove(model_path)  # unreadable or of another layout: refit

                if fit_model or overwrite:
                    ini_path = os.path.join(folder, ini_file)
                    if gaia and gaia_data is None:
                        ra, dec = _ini_radec(ini_path)
                        # the bands the ini measured itself, before Gaia's are
                        # written into it: the fallback strips only the query's
                        native_ini_bands = _ini_native_bands(ini_path)
                        gaia_data = get_gaia_data(ra, dec, radius=gaia_radius)
                        logger.info("Gaia conditioning for %s: %s", folder, gaia_data)
                        if write_ini_file:
                            update_ini_with_gaia(ini_path, gaia_data)
                    if ichrone is None:
                        from . import isochrone

                        ini_bands = StarModel.get_bands(ini_path)
                        all_bands = ini_bands if bands is None else list(bands) + ini_bands
                        gaia_bands = [b for b in (gaia_data or {}) if b != "parallax"]
                        try:
                            ichrone = isochrone.get_ichrone(models, sorted(set(all_bands + gaia_bands)),
                                                            device=device, dtype=dtype)
                        except Exception:
                            if not gaia_bands:
                                raise
                            # the grid lacks the Gaia system: the parallax alone,
                            # and the ini's [gaia] photometry taken out again
                            logger.warning("%s grid lacks Gaia bands %s; conditioning on parallax only.",
                                           models, gaia_bands)
                            gaia_data = {"parallax": gaia_data["parallax"]}
                            if write_ini_file:
                                update_ini_with_gaia(ini_path, gaia_data)
                            # an ini that measured a Gaia band itself keeps it
                            native = set((list(bands) if bands else []) + native_ini_bands)
                            ichrone = isochrone.get_ichrone(
                                models, sorted(set(all_bands) - (set(gaia_bands) - native)),
                                device=device, dtype=dtype)

                    if issubclass(Mod, StarModel):
                        mod = Mod.from_ini(ichrone, folder, use_emcee=use_emcee,
                                           N=NSTARS[mult], ini_file=ini_file, name=name)
                        if gaia_data is not None and not write_ini_file:
                            # the tree is built from the ini on disk: its Gaia
                            # photometry needs write_ini_file, the parallax is added here
                            mod.obs.add_parallax(gaia_data["parallax"])
                    else:
                        obs_kwargs = _flat_obs_kwargs(ini_path)
                        for k, v in (gaia_data or {}).items():
                            if k == "parallax" or k in ichrone.bc.column_index:
                                obs_kwargs[k] = tuple(v)
                        mod = Mod(ichrone, N=NSTARS[mult], name=name, directory=folder,
                                  use_emcee=use_emcee, **obs_kwargs)

                    if feh_prior == "flat":
                        mod.set_prior(feh=FlatPrior((ichrone.minfeh, ichrone.maxfeh)))

                    if getattr(mod, "obs", None) is not None:
                        mod.obs.print_ascii()

                    mod.fit(verbose=verbose, overwrite=overwrite, **kwargs)
                    mod.save_hdf(model_path, overwrite=True)
                else:
                    logger.info("%s exists. Use overwrite to refit.", model_filename)

            # the corner plots, only where missing or stale (reference starfit.py:111-127)
            if not no_plots and mod is not None and mod._samples is not None:
                make_corners = plot_only
                for x in ("physical", "observed"):
                    f = os.path.join(folder, f"{models}_corner_{mult}_{x}.png")
                    if not os.path.exists(f) or (
                        os.path.exists(model_path) and os.path.getmtime(model_path) > os.path.getmtime(f)
                    ):
                        make_corners = True
                        break
                if make_corners:
                    import matplotlib.pyplot as plt

                    for x, draw in (("physical", mod.corner_physical), ("observed", mod.corner_observed)):
                        fig = draw()
                        fig.savefig(os.path.join(folder, f"{models}_corner_{mult}_{x}.png"))
                        plt.close(fig)

            logger.info(
                "%s starfit successful for %s in %.1f minutes.",
                mult, folder, (time.time() - start) / 60,
            )
        except KeyboardInterrupt:
            logger.error("%s starfit interrupted for %s.", mult, folder)
            raise
        except Exception as e:
            logger.error("%s starfit failed for %s.", mult, folder, exc_info=True)
            if failures is not None:
                failures.append((folder, mult))
            if isinstance(e, CheckpointConfigError):
                # an operator's error, not a transient fit failure: it must
                # surface instead of costing a star of a batch run silently
                raise

    return mod, logger


def batch_starfit_script(listfile, nsplit=None, ntasks_per_node=20, minutes_per_fit=5.0, extra=()):
    """Write a SLURM job-array-style batch script sharding a folder list
    (reference scripts/batch_starfit). Returns the script path; submission is
    left to the caller (``sbatch <script>``)."""
    listfile = os.path.abspath(listfile)
    with open(listfile) as lf:
        num_lines = sum(1 for _ in lf)
    nsplit = num_lines if nsplit is None else nsplit

    n_nodes = int(np.ceil(nsplit / ntasks_per_node))
    ntasks = min(nsplit, ntasks_per_node)
    num_per_job = int(np.ceil(num_lines / nsplit))
    tot_minutes = minutes_per_fit * num_per_job
    time_string = "{:02.0f}:{:02.0f}:00".format(tot_minutes // 60, tot_minutes % 60)

    scriptfile = f"{listfile}.batch"
    with open(scriptfile, "w") as f:
        f.write("#!/bin/bash\n")
        f.write(f"#SBATCH -J starfit-{os.path.basename(listfile)}\n")
        f.write(f"#SBATCH -N {n_nodes}\n")
        f.write(f"#SBATCH --ntasks-per-node={ntasks}\n")
        f.write(f"#SBATCH -t {time_string}\n\n")
        f.write(
            "for ((i=0; i<=$(expr $SLURM_NPROCS-1); i++)) do\n"
            f' awk "NR % ${{SLURM_NPROCS}} == $i" {listfile} | xargs starfit-torch '
        )
        for arg in extra:
            f.write(f"{arg} ")
        f.write("&\ndone\nwait\n")
    return scriptfile
