"""``generate-cmd`` CLI of the port (counterpart of
``isochrones_tpu/cli/generate_cmd.py``): an N-star colour-magnitude table of
a simulated cluster whose parameters are drawn at random where not given.
The same flags, with ``--device`` and ``--dtype`` in the place of
``--platform``::

    python -m isochrones_torch.cli.generate_cmd 1000 --models synthetic --seed 0 -o cmd.csv
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

_DTYPES = ("float64", "float32")


def build_parser():
    parser = argparse.ArgumentParser(description="Generate a synthetic cluster CMD table.")
    parser.add_argument("--device", default="cuda",
                        help="torch device the grids live and the stars are made on: cuda (default) or cpu")
    parser.add_argument("--dtype", default="float64", choices=_DTYPES, help="dtype of the grids")
    parser.add_argument("N", type=int, nargs="?", default=None, help="number of stars")
    parser.add_argument("-N", dest="N_flag", type=int, default=None,
                        help="number of stars (reference-compat flag form)")
    parser.add_argument("--output", "-O", "-o", default="cmd.csv")
    parser.add_argument("--models", default="mist")
    parser.add_argument("--bands", default="JHK")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--age", type=float, default=None, help="log10(age); random if omitted")
    parser.add_argument("--feh", type=float, default=None)
    parser.add_argument("--distance", type=float, default=None)
    parser.add_argument("--AV", type=float, default=None)
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.N is None:
        args.N = args.N_flag
    if args.N is None:
        parser.error("number of stars required (positional or -N)")

    rng = np.random.default_rng(args.seed)
    age = args.age if args.age is not None else rng.uniform(8.0, 9.8)
    feh = args.feh if args.feh is not None else rng.uniform(-0.5, 0.3)
    distance = args.distance if args.distance is not None else rng.uniform(200, 2000)
    AV = args.AV if args.AV is not None else rng.uniform(0, 0.3)
    alpha = rng.uniform(-2.5, -1.8)
    gamma = rng.normal(0.3, 0.05)
    fB = rng.uniform(0.2, 0.5)

    import torch

    from ..cluster import simulate_cluster
    from ..isochrone import get_ichrone
    from ..summary import Frame

    iso = get_ichrone(args.models, bands=list(args.bands), device=args.device, dtype=getattr(torch, args.dtype))
    cat = simulate_cluster(args.N, age, feh, distance, AV, alpha, gamma, fB, bands=list(args.bands), iso=iso,
                           rng=rng)
    Frame(cat.data).to_csv(args.output)
    print(f"{args.N}-star CMD written to {args.output}")
    print(f"truth: age={age:.3f} feh={feh:.3f} distance={distance:.0f} AV={AV:.3f} "
          f"alpha={alpha:.2f} gamma={gamma:.2f} fB={fB:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
