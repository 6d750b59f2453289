from .ensemble import EnsembleState, autocorr_time, run_ensemble

__all__ = ["EnsembleState", "run_ensemble", "autocorr_time"]
