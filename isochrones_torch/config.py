"""Global configuration for isochrones_torch (counterpart of
``isochrones_tpu/config.py``, without the JAX compile cache)."""

import os

ISOCHRONES = os.getenv("ISOCHRONES", os.path.expanduser(os.path.join("~", ".isochrones")))

#: Set to "1" to disable any attempt at network downloads (e.g. hermetic CI).
OFFLINE = os.getenv("ISOCHRONES_TPU_OFFLINE", "0") == "1"
