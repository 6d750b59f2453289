"""The on-device samplers (counterpart of ``isochrones_tpu/samplers``): the
affine-invariant ensemble (``run_ensemble``, and ``run_ensemble_batch`` for
whole catalogs), nested sampling (``run_nested``, and its slice-sampling
replacement ``run_polychord``) and the No-U-Turn sampler (``run_nuts``)."""

from .ensemble import EnsembleState, autocorr_time, run_ensemble, run_ensemble_batch
from .nested import CheckpointConfigError, NestedResult, run_nested
from .nuts import NutsResult, run_nuts
from .polychord import run_polychord

__all__ = [
    "EnsembleState", "run_ensemble", "run_ensemble_batch", "autocorr_time",
    "CheckpointConfigError", "NestedResult", "run_nested",
    "NutsResult", "run_nuts", "run_polychord",
]
