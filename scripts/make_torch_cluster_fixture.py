"""Write ``isochrones_torch/data/cluster50_synthetic.csv``: the 50-star
cluster of ``bench.py``'s cluster-fit row, simulated by the JAX package's
``SimulatedCluster`` on the MIST-scale synthetic grid in float64 on the CPU.

The file was made here once, before the port had a cluster simulator, and
committed. The port's own ``isochrones_torch.cluster.SimulatedCluster`` now
reproduces it with the same seed and settings (drawn columns bit for bit,
EEPs and magnitudes to 1e-9): ``chip_smoke.py`` holds it to the file on the
card and ``tests/test_torch_cluster_fit.py`` holds the two classes to each
other on the CPU. This script stays only as the record of the file's origin.
Run from the repository root:

    python -m scripts.make_torch_cluster_fixture
"""

import csv
import os

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from isochrones_tpu import get_ichrone  # noqa: E402
from isochrones_tpu.cluster import SimulatedCluster  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "isochrones_torch", "data", "cluster50_synthetic.csv")
COLUMNS = (
    "J_mag", "J_mag_unc", "H_mag", "H_mag_unc", "K_mag", "K_mag_unc", "parallax", "parallax_unc",
    "is_binary", "distance", "mass_pri", "mass_sec", "eep_pri", "eep_sec",
)


def main():
    iso = get_ichrone("synthetic", n_feh=15, n_mass=196, n_eep=1710, n_age=107)
    sim = SimulatedCluster(
        50, age=9.0, feh=0.0, distance=300.0, AV=0.05, alpha=-2.0,
        gamma=0.3, fB=0.3, bands=("J", "H", "K"), mass_range=(0.6, 2.0),
        ic=iso, rng=0, phot_unc=0.02, distance_scatter=0.0,
    )
    df = sim.df
    with open(OUT, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(COLUMNS)
        for i in range(len(df)):
            w.writerow([repr(float(df[c].iloc[i])) for c in COLUMNS])
    print(f"wrote {len(df)} stars to {OUT}")


if __name__ == "__main__":
    main()
