"""Whether a row of the dense-metric whitening ``mu + W y`` depends on how many rows share the call.

Run from the repository root (on the CPU, and on the card where there is one):

    python -m scripts.check_batch_invariance

``run_nuts`` with a dense metric maps every chain's position through the
lower-triangular factor ``W``. A device mesh hands each shard a slice of the
chains, so the sharded fit is the unsharded one only if a row's result does
not depend on the number of rows in the call. For chain counts ``C``,
dimensions ``d`` (the star, binary and triple models' 5 to 8 parameters),
shard counts 2, 4, 8 and both float types, this compares each shard's rows
with the same rows of the whole call, for ``y @ W.T`` (a matrix product) and
for ``(y[:, None, :] * W).sum(-1)`` (a product and a sum over the last
axis). Prints the card's name and power limit, then one JSON line: the cases
and those whose rows differ, per form and device.
"""

import json
import subprocess

import torch


def main():
    devices = ["cpu"]
    if torch.cuda.is_available():
        devices.append("cuda")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        print(smi.stdout.strip())
    g = torch.Generator().manual_seed(0)
    forms = {"matmul": lambda y, W: y @ W.T, "product_sum": lambda y, W: (y[:, None, :] * W).sum(-1)}
    rec = {"cases": 0, "differ": {f"{f} {dev}": [] for f in forms for dev in devices}}
    for dev in devices:
        for dt in (torch.float32, torch.float64):
            for d in (5, 6, 7, 8):
                for C in (2, 4, 8, 16, 64, 256):
                    W = torch.randn(d, d, generator=g, dtype=torch.float64).tril().to(dev, dt)
                    y = torch.randn(C, d, generator=g, dtype=torch.float64).to(dev, dt)
                    for n in (2, 4, 8):
                        if C % n:
                            continue
                        rec["cases"] += 1
                        for name, f in forms.items():
                            parts = torch.cat([f(p, W) for p in torch.tensor_split(y, n)])
                            if not torch.equal(parts, f(y, W)):
                                rec["differ"][f"{name} {dev}"].append(f"{str(dt)[6:]} d={d} C={C} shards={n}")
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
