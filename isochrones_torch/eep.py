"""Import-path compat: reference ``isochrones/eep.py`` (EEP section-poly
fitting; counterpart of ``isochrones_tpu/eep.py``); the functions live in
:mod:`isochrones_torch.eep_fit`."""

from .eep_fit import eep_fn, eep_fn_p0, eep_jac, fit_section_poly

__all__ = ["eep_fn", "eep_jac", "eep_fn_p0", "fit_section_poly"]
