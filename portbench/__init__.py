"""The benchmark of ``isochrones_torch`` on an NVIDIA card: see README.md."""

import os

#: the root of the checkout, which holds BENCHMARK.json and the program
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
