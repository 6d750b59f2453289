"""The on-device samplers (counterpart of ``isochrones_tpu/samplers``): the
affine-invariant ensemble (``run_ensemble``, and ``run_ensemble_batch`` for
whole catalogs) and nested sampling (``run_nested``)."""

from .ensemble import EnsembleState, autocorr_time, run_ensemble, run_ensemble_batch
from .nested import CheckpointConfigError, NestedResult, run_nested

__all__ = [
    "EnsembleState", "run_ensemble", "run_ensemble_batch", "autocorr_time",
    "CheckpointConfigError", "NestedResult", "run_nested",
]
