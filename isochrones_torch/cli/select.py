"""``starmodel-select`` CLI of the port (counterpart of
``isochrones_tpu/cli/select.py``, reference scripts/starmodel-select): compare
the fitted multiplicities of each folder by their nested-sampling
log-evidence, from the ``<models>_starmodel_<mult>.npz`` results files. The
same flags, with ``--device`` and ``--dtype`` in the place of
``--platform``::

    python -m isochrones_torch.cli.select --models mist FOLDER
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys

import numpy as np

_DTYPES = ("float64", "float32")


def build_parser():
    parser = argparse.ArgumentParser(description="Model selection between fitted multiplicities via log-evidence.")
    parser.add_argument("--device", default="cuda",
                        help="torch device the reloaded models' grids are built on: cuda (default) or cpu")
    parser.add_argument("--dtype", default="float64", choices=_DTYPES, help="dtype of the reloaded models' grids")
    parser.add_argument("folders", nargs="*", default=["."])
    parser.add_argument("--models", default="mist")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from ..starmodel import BasicStarModel

    for folder in args.folders:
        starmodels = glob.glob(os.path.join(folder, f"{args.models}_starmodel_*.npz"))
        names, evidences = [], []
        for sm in starmodels:
            m = re.search(rf"{args.models}_starmodel_(\w+)\.npz", sm)
            if not m:
                continue
            model = BasicStarModel.load_hdf(sm, device=args.device, dtype=getattr(torch, args.dtype))
            if model.evidence is None:
                print(f"{sm}: no evidence stored (emcee fit?)")
                continue
            names.append(m.group(1))
            evidences.append(model.evidence[0])
        if evidences:
            ev = np.array(evidences)
            ev -= ev.max()
            for n, e in sorted(zip(names, ev), key=lambda t: -t[1]):
                print(f"{folder}: {n}  delta_lnZ = {e:.2f}")
        else:
            print(f"{folder}: no fitted models found")
    return 0


if __name__ == "__main__":
    sys.exit(main())
