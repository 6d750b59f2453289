"""Phase 28 of ``chip_smoke.py`` (the device mesh) alone, on one card or across the cards of one machine.

Run from the repository root:

    python -m scripts.check_torch_mesh [--fleet] [--out FILE]

Builds the kernels, the MIST-scale synthetic grids (float32 and float64 on
``cuda:0``), phase 14's 50-star cluster and phase 16's 256-star catalogue,
then runs ``chip_smoke.phase_parallel``. On a machine with one card the four
shards of parts (b)-(d) all lie on it and part (f), the two-process fleet,
runs too. With two or more cards the four shards go to cards 0, 1, 2, 3
(modulo the count; part (e)'s two to the first two), every shard on its own
copy of the model's tables, and the fleet runs only with ``--fleet``. Prints
the card's name and power limit, the phase's lines and its record; ``--out``
writes the record as JSON.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fleet", action="store_true", help="run the two-process fleet (part f) on several cards too")
    ap.add_argument("--out", default=None, help="write the phase's record here as JSON")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    import isochrones_torch as it
    from isochrones_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("check_torch_mesh: no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, {torch.cuda.device_count()} card(s)", flush=True)
    dev = torch.device("cuda", 0)
    n_cards = torch.cuda.device_count()
    cards = [torch.device("cuda", k % n_cards) for k in range(4)]
    _, secs, _ = _build.build()
    _build.load_library()
    print(f"[build] {secs:.1f} s", flush=True)
    t0 = time.perf_counter()
    ic32 = it.get_ichrone("synthetic", device=dev, dtype=torch.float32, **cs.GRID)
    ic64 = it.get_ichrone("synthetic", device=dev, dtype=torch.float64, **cs.GRID)
    sim = it.SimulatedCluster(50, ic=ic64, **cs.CLUSTER_SIM)
    _, table = cs.catalog_table(ic64, cs.CAT_STARS, cs.CAT_EEP_BOX)
    print(f"[setup] {time.perf_counter() - t0:.1f} s", flush=True)
    workdir = tempfile.mkdtemp(prefix="check_torch_mesh_", dir=os.environ.get("TMPDIR") or None)
    t0 = time.perf_counter()
    rec = cs.phase_parallel(dev, ic32, ic64, sim, table, workdir, cards=cards, fleet=n_cards == 1 or args.fleet)
    print(f"[mesh] phase 28 took {time.perf_counter() - t0:.1f} s")
    rec.update(cards=n_cards, card=smi.splitlines()[0])
    print(json.dumps(rec, default=str))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
