"""The port stands alone: importing every module of ``isochrones_torch``
loads no JAX, no JAX-package and no pandas module (the machine with the
card has none of them)."""

import json
import os
import subprocess
import sys

_PROBE = r"""
import importlib, json, pkgutil, sys
import isochrones_torch
for m in pkgutil.walk_packages(isochrones_torch.__path__, "isochrones_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "isochrones_tpu", "pandas"))
print(json.dumps(bad))
"""


def test_port_imports_no_jax_no_pandas():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=root, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
