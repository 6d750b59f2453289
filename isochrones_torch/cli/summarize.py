"""``starfit-summarize`` CLI of the port (counterpart of
``isochrones_tpu/cli/summarize.py``, reference scripts/starfit-summarize):
the quantile table of many fitted folders, or with ``--results-txt`` a
``<models>_<mult>_results.txt`` in each. The same flags, with ``--device``
and ``--dtype`` in the place of ``--platform``::

    python -m isochrones_torch.cli.summarize --rootdir DIR --modelname mist_starmodel_single -O summary.csv a b c

``--ncores N`` maps the folders over a pool of N processes started with
``spawn`` (a forked worker cannot use a CUDA context its parent made).
"""

from __future__ import annotations

import argparse
import os
import sys

_DTYPES = ("float64", "float32")


def build_parser():
    parser = argparse.ArgumentParser(description="Summarize quantiles over many starfit results.")
    parser.add_argument("--device", default="cuda",
                        help="torch device the reloaded models' grids are built on: cuda (default) or cpu")
    parser.add_argument("--dtype", default="float64", choices=_DTYPES, help="dtype of the reloaded models' grids")
    parser.add_argument("names", nargs="*", help="star folder names (or use --filename)")
    parser.add_argument("-f", "--filename", "--listfile", dest="listfile", default=None,
                        help="file with one folder name per line")
    parser.add_argument("--rootdir", default=".")
    parser.add_argument("--modelname", default="mist_starmodel_single")
    parser.add_argument("--output", "-O", "-o", "--outfile", default="summary.csv")
    parser.add_argument("--ncores", "-p", "--processes", dest="ncores", type=int, default=1)
    parser.add_argument("--mpi", action="store_true",
                        help="reference compat: MPI pools are replaced by local multiprocessing over all cores")
    parser.add_argument("--raise_exceptions", action="store_true")
    parser.add_argument("--columns", nargs="*", default=["eep", "mass", "radius", "age", "feh", "distance", "AV"])
    # reference "folders" mode: per-folder {models}_{mult}_results.txt
    parser.add_argument("--results-txt", action="store_true", dest="results_txt",
                        help="write per-folder results.txt files instead of one summary table")
    parser.add_argument("--binary", action="store_true")
    parser.add_argument("--triple", action="store_true")
    parser.add_argument("--all", action="store_true")
    parser.add_argument("--models", default="mist")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    names = list(args.names)
    if args.listfile:
        with open(args.listfile) as f:
            names += [line.strip() for line in f if line.strip()]
    if not names:
        # reference default: the current folder (scripts/starfit-summarize:31)
        names = ["."]

    if args.results_txt or args.binary or args.triple or args.all:
        # reference scripts/starfit-summarize:63-110: med/lo/hi tables beside
        # each fitted model
        import logging

        from ..summary import write_results_txt

        if args.all:
            multiplicities = ["single", "binary", "triple"]
        elif args.binary:
            multiplicities = ["binary"]
        elif args.triple:
            multiplicities = ["triple"]
        else:
            multiplicities = ["single"]
        for folder in names:
            for mult in multiplicities:
                try:
                    path = write_results_txt(os.path.join(args.rootdir, folder), models=args.models, mult=mult)
                    print(path)
                except KeyboardInterrupt:
                    raise
                except Exception:
                    if args.raise_exceptions:
                        raise
                    logging.error("failed to write starfit summary file (%s) for %s.", mult, folder, exc_info=True)
        return 0

    import torch

    from ..summary import get_summary_df

    ncores = args.ncores
    if args.mpi:
        ncores = max(os.cpu_count() or 1, ncores)
    pool = None
    if ncores > 1:
        import multiprocessing

        pool = multiprocessing.get_context("spawn").Pool(ncores)
    try:
        df = get_summary_df(
            names=names, pool=pool, rootdir=args.rootdir, modelname=args.modelname,
            columns=tuple(args.columns), filename=args.output,
            raise_exceptions=args.raise_exceptions, device=args.device, dtype=getattr(torch, args.dtype),
        )
    finally:
        if pool is not None:
            pool.close()
            pool.join()
    df.iloc[:5].to_csv(sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
