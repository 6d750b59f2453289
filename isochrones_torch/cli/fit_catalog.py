"""``fit-catalog`` CLI of the port (counterpart of
``isochrones_tpu/cli/fit_catalog.py``): fit every star of a catalog table at
once, then write the per-star quantile summary. The same flags, with
``--device`` and ``--dtype`` in the place of ``--platform``::

    python -m isochrones_torch.cli.fit_catalog --models synthetic --method nested STARS.csv -O summary.csv
"""

from __future__ import annotations

import argparse
import sys

_DTYPES = ("float64", "float32")


def build_parser():
    parser = argparse.ArgumentParser(description="Fit all stars of a catalog simultaneously (batched ensembles).")
    parser.add_argument("--device", default="cuda",
                        help="torch device the grids live and the fit runs on: cuda (default) or cpu")
    parser.add_argument("--dtype", default="float64", choices=_DTYPES, help="dtype of the grids and the fit")
    parser.add_argument("catalog", help="CSV table with <band>_mag/_unc (+ prop/_unc) columns")
    parser.add_argument("--models", default="mist")
    parser.add_argument("--bands", nargs="*", default=None)
    parser.add_argument("--props", nargs="*", default=None,
                        help="non-photometric columns (Teff, logg, feh, parallax)")
    parser.add_argument("--method", choices=["mcmc", "nested"], default="mcmc",
                        help="'nested' also writes per-star log-evidences")
    parser.add_argument("--n-live-points", type=int, default=500, dest="n_live_points")
    parser.add_argument("--dynamic", action="store_true",
                        help="(nested) dynamic NS: posterior threads lift every star's ESS to target")
    parser.add_argument("--nwalkers", type=int, default=128)
    parser.add_argument("--nburn", type=int, default=500)
    parser.add_argument("--niter", type=int, default=100)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--output", "-O", default="catalog_fit.csv")
    # sharding of the rows across processes: accepted, not ported yet
    parser.add_argument("--multihost", action="store_true", help="shard the rows across processes (not ported yet)")
    parser.add_argument("--coordinator", default=None)
    parser.add_argument("--num-processes", type=int, default=None, dest="num_processes")
    parser.add_argument("--process-id", type=int, default=None, dest="process_id")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.multihost or args.coordinator is not None or args.num_processes is not None \
            or args.process_id is not None:
        raise NotImplementedError("sharding a catalog across processes is not ported yet (ROADMAP queue 1, "
                                  "parallelism)")
    if str(args.catalog).endswith((".h5", ".hdf", ".hdf5")):
        raise NotImplementedError("an HDF table needs pandas, which the port does not use; give a CSV table")

    import torch

    from ..batch import fit_catalog
    from ..catalog import StarCatalog, read_csv
    from ..isochrone import get_ichrone

    cat = StarCatalog(read_csv(args.catalog), bands=args.bands, props=args.props)
    ic = get_ichrone(args.models, bands=list(cat.bands), device=args.device, dtype=getattr(torch, args.dtype))
    _, summary = fit_catalog(
        ic, cat, method=args.method, nwalkers=args.nwalkers, nburn=args.nburn, niter=args.niter,
        n_live_points=args.n_live_points, seed=args.seed, dynamic=args.dynamic,
    )
    summary.to_csv(args.output)
    print(f"{len(cat)} stars fitted; per-star quantiles written to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
