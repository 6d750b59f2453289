"""``fit-catalog`` CLI of the port (counterpart of
``isochrones_tpu/cli/fit_catalog.py``): fit every star of a catalog table at
once, then write the per-star quantile summary. The table is a CSV file or a
pandas HDF table (``.h5``, ``.hdf``, ``.hdf5``; the ``fixed`` or ``table``
format), as in the JAX package. The same flags, with ``--device`` and
``--dtype`` in the place of ``--platform``::

    python -m isochrones_torch.cli.fit_catalog --models synthetic --method nested STARS.csv -O summary.csv

With ``--multihost`` (or ``--coordinator``) each process of a fleet fits its
contiguous shard of the rows and writes ``<output>.part<process id>``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

_DTYPES = ("float64", "float32")


def build_parser():
    parser = argparse.ArgumentParser(description="Fit all stars of a catalog simultaneously (batched ensembles).")
    parser.add_argument("--device", default="cuda",
                        help="torch device the grids live and the fit runs on: cuda (default) or cpu")
    parser.add_argument("--dtype", default="float64", choices=_DTYPES, help="dtype of the grids and the fit")
    parser.add_argument("catalog", help="CSV or pandas HDF (.h5/.hdf/.hdf5) table with <band>_mag/_unc "
                                        "(+ prop/_unc) columns")
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
    # fleet sharding: each process fits its shard of the rows
    parser.add_argument("--multihost", action="store_true",
                        help="shard the rows across the processes of a torch.distributed (gloo) fleet")
    parser.add_argument("--coordinator", default=None)
    parser.add_argument("--num-processes", type=int, default=None, dest="num_processes")
    parser.add_argument("--process-id", type=int, default=None, dest="process_id")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from ..batch import fit_catalog
    from ..catalog import StarCatalog, read_table
    from ..isochrone import get_ichrone

    table = read_table(args.catalog)
    output = args.output
    if args.multihost or args.coordinator is not None:
        from ..parallel.multihost import initialize_distributed, process_shard

        pid, nproc = initialize_distributed(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )
        n_rows = len(next(iter(table.values()))) if table else 0
        rows = np.asarray(process_shard(list(range(n_rows)), pid, nproc), dtype=np.int64)
        table.setdefault("index", np.arange(n_rows))  # the part keeps the table's row labels
        table = {c: np.asarray(v)[rows] for c, v in table.items()}
        output = f"{args.output}.part{pid}"
        print(f"[multihost] process {pid}/{nproc}: {len(rows)} star(s) -> {output}")

    cat = StarCatalog(table, bands=args.bands, props=args.props)
    ic = get_ichrone(args.models, bands=list(cat.bands), device=args.device, dtype=getattr(torch, args.dtype))
    _, summary = fit_catalog(
        ic, cat, method=args.method, nwalkers=args.nwalkers, nburn=args.nburn, niter=args.niter,
        n_live_points=args.n_live_points, seed=args.seed, dynamic=args.dynamic,
    )
    summary.to_csv(output)
    print(f"{len(cat)} stars fitted; per-star quantiles written to {output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
