"""Subprocess worker for the port's two-process fleet tests
(``tests/test_torch_multihost.py``).

Usage: ``python _torch_multihost_worker.py <mode> <outdir>`` with the fleet's
settings in ``ISOCHRONES_TPU_{COORDINATOR,NUM_PROCESSES,PROCESS_ID}``. Each
process joins the gloo fleet, maps its shard of a shared work list and writes
``proc<id>.json``. ``mode`` is ``trivial`` (squares of integers, then a
barrier that process 1 reaches 3 s late) or ``fits`` (a short ensemble fit of
one star per item, as ``tests/_multihost_worker.py`` runs in the JAX
package).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LATE_S = 3.0


def main():
    mode, outdir = sys.argv[1], sys.argv[2]
    import torch

    torch.set_num_threads(1)
    from isochrones_torch.parallel.multihost import _fleet_barrier, fleet_map, initialize_distributed, process_shard

    pid, nproc = initialize_distributed()
    if mode == "trivial":
        work = list(range(7))
        results = fleet_map(lambda x: x * x, work)
        if pid == 1:
            time.sleep(LATE_S)
        t0 = time.perf_counter()
        _fleet_barrier("late", timeout_s=60.0)
        extra = {"barrier_wait_s": time.perf_counter() - t0}
    else:
        import numpy as np

        from isochrones_torch import SingleStarModel, get_ichrone

        iso = get_ichrone("synthetic", device="cpu", n_feh=5, n_mass=16, n_eep=50, n_age=16)
        work = [30.0, 32.0, 34.0, 36.0, 38.0]  # five "stars" (true EEPs)

        def fit_one(eep_true):
            Teff, logg, _, mags = iso.interp_mag([eep_true, 9.0, 0.0, 200.0, 0.1], ["J", "H"])
            m = SingleStarModel(iso, Teff=(float(Teff), 100.0), J=(float(mags[0]), 0.02), H=(float(mags[1]), 0.02),
                                parallax=(5.0, 0.05))
            s = m.fit_mcmc(nwalkers=64, nburn=500, niter=50, seed=int(eep_true), moves="mixed")
            return {"eep_true": eep_true, "eep_med": float(np.median(s["eep"]))}

        results = fleet_map(fit_one, work)
        extra = {}
    assert len(results) == len(process_shard(work, pid, nproc))
    with open(os.path.join(outdir, f"proc{pid}.json"), "w") as f:
        json.dump(dict(pid=pid, nproc=nproc, shard=process_shard(work, pid, nproc), results=results, **extra), f)


if __name__ == "__main__":
    main()
