"""Star log-likelihood, composed from the generic operations (counterpart of
``isochrones_tpu/ops/likelihood.py``).

``star_lnlike`` unpacks the N-component parameter vector (5/6/7 parameters
for single/binary/triple), evaluates every component's magnitudes with one
batched :func:`~isochrones_torch.ops.mags.interp_mag`, flux-sums them, and
adds Gaussian log-likelihoods over spectroscopy (Teff, logg, feh of the
primary; a NaN observation is skipped) and photometry. The Gaussian constant
is ``log(1/sqrt(2 pi)) + log(unc)``, the reference's sign quirk
(likelihood.py:13), kept for parity. The fused version, which also serves
the EEP prior, is :mod:`isochrones_torch.ops.star`.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .interp import GridData
from .mags import interp_mag

__all__ = ["LOG_ONE_OVER_ROOT_2PI", "gauss_lnprob", "stack_components", "spectroscopy_lnlike", "star_lnlike"]

LOG_ONE_OVER_ROOT_2PI = math.log(1.0 / math.sqrt(2.0 * math.pi))


def gauss_lnprob(val, unc, model_val):
    """reference likelihood.py:10-13 (constant-sign quirk kept). ``val`` and
    ``unc`` are tensors or Python floats."""
    resid = val - model_val
    log_unc = torch.log(unc) if isinstance(unc, torch.Tensor) else math.log(unc)
    return LOG_ONE_OVER_ROOT_2PI + log_unc - 0.5 * resid * resid / (unc * unc)


def stack_components(pars: torch.Tensor, n_stars: int) -> torch.Tensor:
    """(..., N+4) parameters -> (..., N, 5) per-component rows: component i
    takes ``pars[..., i]`` and the shared trailing 4 parameters."""
    shared = pars[..., n_stars:]
    comps = [torch.cat([pars[..., i : i + 1], shared], dim=-1) for i in range(n_stars)]
    return torch.stack(comps, dim=-2)


def spectroscopy_lnlike(spec_vals, spec_uncs, model_vals, like):
    """Sum of the Gaussian terms of the observed (Teff, logg, feh); a channel
    whose value or uncertainty is NaN adds exactly 0. ``spec_vals`` and
    ``spec_uncs`` are host sequences of 3 floats."""
    ll = torch.zeros_like(like)
    for val, unc, model_val in zip(spec_vals, spec_uncs, model_vals):
        if not (math.isnan(val) or math.isnan(unc)):
            ll = ll + gauss_lnprob(float(val), float(unc), model_val)
    return ll


def star_lnlike(
    pars: torch.Tensor,
    index_order: Tuple[int, ...],
    spec_vals,
    spec_uncs,
    mag_vals: torch.Tensor,
    mag_uncs: torch.Tensor,
    model: GridData,
    model_icols: Tuple[int, int, int, int],
    bc: GridData,
    band_icols: Tuple[int, ...],
    n_stars: int = None,
):
    """Single/binary/triple star log-likelihood (reference likelihood.py:16-147).

    pars : (..., N+4) with N in {1, 2, 3}.
    spec_vals, spec_uncs : 3 host floats, observed (Teff, logg, feh); NaN = missing.
    mag_vals, mag_uncs : (n_bands,) tensors of observed magnitudes.
    band_icols : band columns of the BC grid (may be empty).

    Returns the log-likelihood with the leading batch shape of ``pars``.
    """
    if n_stars is None:
        n_stars = pars.shape[-1] - 4
    comp_pars = stack_components(pars, n_stars)  # (..., N, 5)
    Teffs, loggs, fehs, comp_mags = interp_mag(comp_pars, index_order, model, model_icols, bc, band_icols)
    if n_stars == 1:
        mags = comp_mags[..., 0, :]
    else:
        mags = -2.5 * torch.log10(torch.sum(10.0 ** (-0.4 * comp_mags), dim=-2))

    lnlike = spectroscopy_lnlike(spec_vals, spec_uncs, (Teffs[..., 0], loggs[..., 0], fehs[..., 0]),
                                 pars[..., 0])
    if len(band_icols):
        lnlike = lnlike + torch.sum(gauss_lnprob(mag_vals, mag_uncs, mags), dim=-1)
    return lnlike
