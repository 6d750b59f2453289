"""Import-path compat: reference ``isochrones/likelihood.py`` (counterpart of
``isochrones_tpu/likelihood.py``); the functions live in
:mod:`isochrones_torch.ops.likelihood`."""

from .ops.likelihood import LOG_ONE_OVER_ROOT_2PI, gauss_lnprob, star_lnlike

__all__ = ["gauss_lnprob", "star_lnlike", "LOG_ONE_OVER_ROOT_2PI"]
