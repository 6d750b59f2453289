"""``mist-initialize-torch``: build the MIST grids' caches under
``$ISOCHRONES`` from the MIST files there (counterpart of
``isochrones_tpu/cli/initialize.py``; reference scripts/mist-initialize.py).
Nothing is downloaded: a missing file is reported with its path.

    python -m isochrones_torch.cli.initialize [--models mist] [--bands J H K] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(description="Build the model grids' caches from their files.")
    parser.add_argument("--models", default="mist")
    parser.add_argument("--bands", nargs="*", default=None)
    parser.add_argument("--device", default="cuda", help="where the grids are built (default: the CUDA card)")
    args = parser.parse_args(argv)

    from ..isochrone import get_ichrone

    iso = get_ichrone(args.models, bands=args.bands, device=args.device)
    iso.initialize()
    track = get_ichrone(args.models, bands=args.bands, tracks=True, device=args.device)
    track.initialize()
    print("Grids initialized.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
