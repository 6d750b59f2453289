"""``starfit`` CLI of the port (counterpart of ``isochrones_tpu/cli/starfit.py``,
reference scripts/starfit:34-106). The same flags, with ``--device`` and
``--dtype`` in the place of ``--platform``::

    python -m isochrones_torch.cli.starfit --models synthetic --no_plots FOLDER

Without ``--no_plots`` it draws the corner plots (matplotlib); with
``--gaia`` it conditions on the closest Gaia source.
"""

from __future__ import annotations

import argparse
import sys

_DTYPES = ("float64", "float32")


def build_parser():
    parser = argparse.ArgumentParser(
        description="Fit physical properties of a star conditioned on observed quantities."
    )
    parser.add_argument("--device", default="cuda",
                        help="torch device the grids live and the fit runs on: cuda (default) or cpu")
    parser.add_argument("--dtype", default="float64", choices=_DTYPES, help="dtype of the grids and the fit")
    parser.add_argument("folders", nargs="*", default=["."])
    parser.add_argument("--binary", action="store_true")
    parser.add_argument("--triple", action="store_true")
    parser.add_argument("--all", action="store_true")
    parser.add_argument("--models", default="mist")
    parser.add_argument("--emcee", action="store_true", help="use on-device ensemble MCMC instead of nested sampling")
    parser.add_argument("--fehprior", default="local")
    parser.add_argument("--plot_only", action="store_true")
    parser.add_argument("-o", "--overwrite", action="store_true")
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("--no_plots", action="store_true")
    parser.add_argument("--n_live_points", type=int, default=1000)
    parser.add_argument("--max_iter", type=int, default=None)
    parser.add_argument("--dynamic", action="store_true",
                        help="dynamic nested sampling: posterior-focused threads to reach --min_ess cheaply")
    parser.add_argument("--resume", action="store_true",
                        help="checkpoint the nested-sampling state after every chunk (under the model's "
                             "chains basename) and resume from an existing checkpoint; the completed fit "
                             "is bitwise the fit that never stopped")
    parser.add_argument("--min_ess", type=float, default=None,
                        help="posterior effective-sample-size target for the nested fit")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--bands", nargs="*", default=None, help="Additional band(s) to include in samples.")
    parser.add_argument("--gaia", action="store_true",
                        help="condition on the closest Gaia source (query.Gaia.table_provider, or astroquery where "
                             "installed)")
    parser.add_argument("--write_ini", action="store_true",
                        help="with --gaia, persist the queried values into star.ini")
    parser.add_argument("--rootdir", type=str, default=None,
                        help="resolve folders relative to this directory")
    parser.add_argument("--gaia_radius", type=float, default=5.0,
                        help="Gaia query radius in arcsec")
    parser.add_argument("--tree", action="store_true", help="use the tree-based StarModel (resolved systems)")
    # sharding of the folder list across processes: accepted, not ported yet
    parser.add_argument("--multihost", action="store_true",
                        help="shard the folder list across processes (not ported yet)")
    parser.add_argument("--coordinator", default=None, help="coordinator address host:port (multihost)")
    parser.add_argument("--num-processes", type=int, default=None, dest="num_processes")
    parser.add_argument("--process-id", type=int, default=None, dest="process_id")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.multihost or args.coordinator is not None or args.num_processes is not None \
            or args.process_id is not None:
        raise NotImplementedError("sharding folders across processes is not ported yet (ROADMAP queue 1, parallelism)")

    import torch

    from ..starfit import starfit

    folders = list(args.folders)
    if args.all:
        multiplicities = ["single", "binary", "triple"]
    elif args.binary:
        multiplicities = ["binary"]
    elif args.triple:
        multiplicities = ["triple"]
    else:
        multiplicities = ["single"]

    starmodel_type = None
    if args.tree:
        from ..treemodel import StarModel

        starmodel_type = StarModel

    logger = None
    fit_kwargs = dict(n_live_points=args.n_live_points, seed=args.seed)
    if args.max_iter is not None:
        fit_kwargs["max_iter"] = args.max_iter
    if args.dynamic:
        fit_kwargs["dynamic"] = True
    if args.min_ess is not None:
        fit_kwargs["min_ess"] = args.min_ess
    if args.resume:
        if args.emcee:
            parser.error("--resume applies to the nested-sampling path (drop --emcee)")
        fit_kwargs["resume"] = True

    failures = []
    for i, folder in enumerate(folders):
        print(f"{i + 1} of {len(folders)}: {folder}")
        mod, logger = starfit(
            folder,
            failures=failures,
            multiplicities=multiplicities,
            models=args.models,
            use_emcee=args.emcee,
            feh_prior=args.fehprior,
            plot_only=args.plot_only,
            overwrite=args.overwrite,
            verbose=args.verbose,
            no_plots=args.no_plots,
            logger=logger,
            bands=args.bands,
            starmodel_type=starmodel_type,
            gaia=args.gaia,
            write_ini_file=args.write_ini,
            rootdir=args.rootdir,
            gaia_radius=args.gaia_radius,
            device=args.device,
            dtype=getattr(torch, args.dtype),
            **fit_kwargs,
        )
        del mod
    if failures:
        # failed folders are logged and skipped, but the shell must not see
        # success: batch and recovery workflows key off the exit code
        print(f"{len(failures)} fit(s) failed: "
              + ", ".join(f"{f} [{m}]" for f, m in failures), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
