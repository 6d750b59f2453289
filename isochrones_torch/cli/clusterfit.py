"""``clusterfit`` CLI of the port (counterpart of
``isochrones_tpu/cli/clusterfit.py``, reference scripts/clusterfit.py). The
same flags, with ``--device`` and ``--dtype`` in the place of ``--platform``::

    python -m isochrones_torch.cli.clusterfit --models synthetic STARS.csv
"""

from __future__ import annotations

import argparse
import sys

_DTYPES = ("float64", "float32")


def build_parser():
    parser = argparse.ArgumentParser(description="Fit cluster properties to a table of member stars.")
    parser.add_argument("--device", default="cuda",
                        help="torch device the grids live and the fit runs on: cuda (default) or cpu")
    parser.add_argument("--dtype", default="float64", choices=_DTYPES, help="dtype of the grids and the fit")
    parser.add_argument("starfile", help="CSV table of member-star photometry")
    parser.add_argument("--bands", nargs="*", default=None)
    parser.add_argument("--props", nargs="*", default=None)
    parser.add_argument("--models", default="mist")
    parser.add_argument("--max_distance", type=float, default=10000)
    parser.add_argument("--mineep", type=int, default=200)
    parser.add_argument("--maxeep", type=int, default=800)
    parser.add_argument("--maxAV", type=float, default=0.1)
    parser.add_argument("--minq", type=float, default=0.2)
    parser.add_argument("-o", "--overwrite", action="store_true")
    parser.add_argument("--nlive", type=int, default=1000)
    parser.add_argument("--name", default="")
    parser.add_argument("--halo_fraction", type=float, default=0.5)
    parser.add_argument("--max_iter", type=int, default=None)
    parser.add_argument("--dynamic", action="store_true", default=None,
                        help="dynamic nested sampling (the default for cluster fits: the marginal is "
                             "costly per call, so the threads' saving of calls is wall-clock); "
                             "--static forces classic static nested sampling")
    parser.add_argument("--static", action="store_false", dest="dynamic",
                        help="force static nested sampling")
    parser.add_argument("--min_ess", type=float, default=None)
    parser.add_argument("--eep-step", type=float, default=1.0,
                        help="EEP-ladder spacing of the marginalization; <1 resolves "
                             "sub-EEP likelihood peaks at few-mmag precision")
    parser.add_argument("--q-jacobian", action="store_true",
                        help="use the corrected mass-ratio measure (|dq/dEEP2| change of "
                             "variables) instead of exact reference parity")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from ..cluster import clusterfit

    clusterfit(
        args.starfile, bands=args.bands, props=args.props, models=args.models,
        max_distance=args.max_distance, mineep=args.mineep, maxeep=args.maxeep,
        maxAV=args.maxAV, minq=args.minq, overwrite=args.overwrite,
        nlive=args.nlive, name=args.name, halo_fraction=args.halo_fraction,
        max_iter=args.max_iter, eep_step=args.eep_step, q_jacobian=args.q_jacobian,
        dynamic=args.dynamic, min_ess=args.min_ess,
        device=args.device, dtype=getattr(torch, args.dtype),
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
