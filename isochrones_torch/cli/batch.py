"""``batch-starfit`` CLI of the port (counterpart of
``isochrones_tpu/cli/batch.py``, reference scripts/batch_starfit): write a
SLURM batch script that shards a list of star folders over the job's tasks,
each running ``starfit-torch`` on its share, and submit it with ``sbatch``
unless ``--no_submit``::

    python -m isochrones_torch.cli.batch FOLDERS.txt -n 40 --no_submit -- --models synthetic --device cuda
"""

from __future__ import annotations

import argparse
import subprocess
import sys


def build_parser():
    parser = argparse.ArgumentParser(description="Fire up a batch starfit job")
    parser.add_argument("file", type=str, help="text file with one star folder per line")
    parser.add_argument("-n", "--nsplit", type=int, default=None)
    parser.add_argument("--ntasks_per_node", type=int, default=20)
    parser.add_argument("-t", "--time", type=float, default=5, help="minutes per fit")
    parser.add_argument("--no_submit", action="store_true", help="write the script but do not sbatch it")
    parser.add_argument("extra", nargs=argparse.REMAINDER, help="arguments handed to starfit-torch")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..starfit import batch_starfit_script

    script = batch_starfit_script(args.file, nsplit=args.nsplit, ntasks_per_node=args.ntasks_per_node,
                                  minutes_per_fit=args.time, extra=args.extra)
    print(f"Batch script written to {script}")
    if not args.no_submit:
        subprocess.call(["sbatch", script])
    return 0


if __name__ == "__main__":
    sys.exit(main())
