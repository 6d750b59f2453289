"""The catalog posterior: plain PyTorch version and dispatcher.

Counterpart of the JAX package's catalog posterior
(``isochrones_tpu/batch.py:145-208``, ``_build_lnpost_data``), which XLA
compiles into one program. For parameters ``(S, B, 5)`` in the order
``(eep, age, feh, distance, AV)`` (S stars, B points each) the likelihood
interpolates the 6-column packed table once per point (Teff, logg, feh,
Mbol, the EEP-prior quantity and its d/dEEP derivative), then the BC grid at
(Teff, logg, feh, AV), forms the magnitudes with the distance modulus and
adds each star's own Gaussian spectroscopy, photometry and parallax terms. A
NaN observation (spectroscopy value, band or parallax) adds exactly 0; a NaN
or out-of-bounds coordinate makes the point's interpolation NaN, and so its
``ll``. :func:`catalog_lnlike_plain` returns ``(ll, orig_val, deriv)``.

The posterior (:func:`catalog_lnpost_plain`) adds the default priors of
:class:`~isochrones_torch.batch.BatchStarFitter` from constants packed once
per fitter (:func:`pack_catalog_priors`, a :class:`CatalogPriors`): the
flat-log age prior, the [Fe/H] disk-and-halo prior, the flat AV prior, the
per-star distance power law and the EEP change of variables
``Chabrier(orig_val) + ln max(deriv, 1e-300)``, then NaN ``ll`` -> -inf and
-inf wherever the prior sum is not finite. It takes parameters, or the
nested fit's unit-cube points with the per-star box tops ``his`` (S, 5): the
box map ``los + (his - los) * u`` comes first. A prior object of another
class has its flag off: its term is left to the caller (the fitter adds it
with the object's own ``lnpdf``), and for the mass prior the call also
returns ``orig_val``.

:func:`catalog_lnlike` and :func:`catalog_lnpost` dispatch on the device: a
CPU tensor takes the plain version, a CUDA tensor the hand-written kernel
(:mod:`isochrones_torch.ops.catalog_cuda`), with no fallback between them.
The plain versions are also the kernel's oracle on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .interp import GridData, interp_nd_plain
from .likelihood import gauss_lnprob

__all__ = [
    "CatalogLikelihood", "CatalogPriors", "CONST_NAMES", "PRIOR_TERMS", "pack_catalog_priors", "unit_box",
    "catalog_lnlike_plain", "catalog_lnlike", "catalog_lnpost_plain", "catalog_lnpost",
]

_NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True, eq=False)
class CatalogLikelihood:
    """What the catalog likelihood needs besides the parameters: the grids,
    the parameter layout and every star's observations, as tensors with a
    leading star axis on the grids' device and in their dtype. NaN marks a
    missing observation."""

    index_order: Tuple[int, ...]  # user order -> (grid axes 0..2, distance, AV)
    pack6: GridData  # (n0, n1, n2, 6) model table, see model_packed6
    bc: GridData  # (b0, b1, b2, b3, bands) BC table
    band_icols: Tuple[int, ...]
    spec_vals: torch.Tensor  # (S, 3) observed Teff, logg, feh
    spec_uncs: torch.Tensor  # (S, 3)
    mag_vals: torch.Tensor  # (S, n_bands)
    mag_uncs: torch.Tensor  # (S, n_bands)
    plax: Optional[torch.Tensor] = None  # (S,) [mas]
    plax_unc: Optional[torch.Tensor] = None  # (S,)

    @property
    def n_stars(self) -> int:
        return self.spec_vals.shape[0]


def catalog_lnlike_plain(pars: torch.Tensor, lk: CatalogLikelihood):
    """(S, B, 5) -> (ll (S, B), orig_val (S, B), deriv (S, B)) in plain torch
    ops, on any device."""
    io = lk.index_order
    grid_pts = torch.stack([pars[..., io[0]], pars[..., io[1]], pars[..., io[2]]], dim=-1)
    pack6 = lk.pack6
    vals6 = interp_nd_plain(pack6.values, pack6.knots, grid_pts, icols=(0, 1, 2, 3, 4, 5),
                      axis_maps=pack6.axis_maps)  # (S, B, 6)
    model_vals = (vals6[..., 0], vals6[..., 1], vals6[..., 2])

    ll = torch.zeros(pars.shape[:-1], dtype=pars.dtype, device=pars.device)
    for k, model_val in enumerate(model_vals):
        val, unc = lk.spec_vals[:, None, k], lk.spec_uncs[:, None, k]
        ll = ll + torch.where(torch.isnan(val), 0.0, gauss_lnprob(val, unc, model_val))
    if len(lk.band_icols):
        bc = lk.bc
        bc_pts = torch.stack([vals6[..., 0], vals6[..., 1], vals6[..., 2], pars[..., 4]], dim=-1)
        bc_vals = interp_nd_plain(bc.values, bc.knots, bc_pts, icols=lk.band_icols, axis_maps=bc.axis_maps)
        dist_mod = 5.0 * torch.log10(pars[..., 3] / 10.0)
        mags = vals6[..., 3, None] + dist_mod[..., None] - bc_vals  # (S, B, n_bands)
        mag_vals, mag_uncs = lk.mag_vals[:, None, :], lk.mag_uncs[:, None, :]
        # each NaN band's term is dropped before the sum
        terms = torch.where(torch.isnan(mag_vals), 0.0, gauss_lnprob(mag_vals, mag_uncs, mags))
        ll = ll + torch.sum(terms, dim=-1)
    if lk.plax is not None:
        plax, plax_unc = lk.plax[:, None], lk.plax_unc[:, None]
        ll = ll + torch.where(torch.isnan(plax), 0.0, gauss_lnprob(plax, plax_unc, 1000.0 / pars[..., 3]))
    return ll, vals6[..., 4], vals6[..., 5]


def catalog_lnlike(pars: torch.Tensor, lk: CatalogLikelihood):
    """The catalog likelihood: CPU tensors take :func:`catalog_lnlike_plain`,
    CUDA tensors the kernel."""
    kind = pars.device.type
    if kind == "cuda":
        from .catalog_cuda import catalog_lnlike_cuda

        return catalog_lnlike_cuda(pars, lk)
    if kind == "cpu":
        return catalog_lnlike_plain(pars, lk)
    raise ValueError(f"catalog_lnlike runs on cpu or cuda tensors, got {kind}")


#: the packed prior constants, in the order of ``Const`` in
#: ``csrc/catalog_lnlike.cu``: the flat-log age prior, the [Fe/H] prior (its
#: bounds, halo and disk weights, log-normalization, and the three Gaussians
#: of ``FehPrior._halo``/``_disk``), the flat AV prior, the Chabrier prior
#: (its bounds, breakpoint and two log-norms, the log-normal below and the
#: power law above), the EEP bounds and the unit-cube box's bottoms
CONST_NAMES = (
    "age_lo", "age_hi", "age_lnln10", "age_ln10", "age_lnnorm",
    "feh_lo", "feh_hi", "feh_halo", "feh_disk", "feh_lnnorm", "feh_halo_c", "feh_halo_mu", "feh_halo_var",
    "feh_disk_c", "feh_a1", "feh_m1", "feh_v1", "feh_a2", "feh_m2", "feh_v2",
    "av_lo", "av_hi", "av_lnp",
    "mass_lo", "mass_hi", "mass_break", "mass_lnnorm0", "mass_lnnorm1",
    "ln_lo", "ln_hi", "ln_lnnorm", "ln_scale", "ln_log_s", "ln_sigma", "ln_mu", "ln_c0",
    "pl_lo", "pl_hi", "pl_lnc", "pl_alpha",
    "eep_lo", "eep_hi",
    "los0", "los1", "los2", "los3", "los4",
)
#: the prior terms a flag turns on, in the order of ``CatalogPriors.on``
PRIOR_TERMS = ("age", "feh", "AV", "mass")


@dataclasses.dataclass(frozen=True, eq=False)
class CatalogPriors:
    """The catalog posterior's prior constants, packed once per fitter.

    consts : every name of :data:`CONST_NAMES` to a Python float (NaN for a
        term whose flag is off).
    on : per term of :data:`PRIOR_TERMS`, whether the posterior computes it
        from ``consts``; a term that is off is the caller's.
    dist : (S, 2) ``d_hi`` and ``ln 3 - 3 ln d_hi`` per star, in the
        working dtype on the working device.
    """

    consts: Dict[str, float]
    on: Tuple[bool, bool, bool, bool]
    dist: torch.Tensor


def _bounds(prior):
    lo, hi = prior.bounds if prior.bounds is not None else (-np.inf, np.inf)
    return float(lo), float(hi)


def pack_catalog_priors(priors, eep_bounds, los, d_hi: torch.Tensor) -> CatalogPriors:
    """Pack the fitter's ``priors`` (keys "age", "feh", "AV", "mass"), its EEP
    bounds, the unit-cube box's bottoms ``los`` (5,) and the per-star
    distance bound ``d_hi`` (S,) into a :class:`CatalogPriors`. A prior takes
    the packed route when its class is the default's family: ``AgePrior`` or
    ``FlatLogPrior``; ``FehPrior`` with ``local=True``; ``AVPrior`` or
    ``FlatPrior``; ``ChabrierPrior`` or a ``BrokenPrior`` of a
    ``LogNormalPrior`` and a ``PowerLawPrior`` at one breakpoint."""
    from .. import priors as P

    c = dict.fromkeys(CONST_NAMES, float("nan"))
    age, feh, av, mass = (priors[k] for k in PRIOR_TERMS)
    on_age = type(age) in (P.AgePrior, P.FlatLogPrior)
    if on_age:
        lo, hi = _bounds(age)
        c.update(age_lo=lo, age_hi=hi, age_lnln10=math.log(math.log(10)), age_ln10=math.log(10),
                 age_lnnorm=math.log(10 ** hi - 10 ** lo))
    on_feh = type(feh) is P.FehPrior and feh.local
    if on_feh:
        lo, hi = _bounds(feh)
        c.update(feh_lo=lo, feh_hi=hi, feh_halo=feh.halo_fraction, feh_disk=1 - feh.halo_fraction,
                 feh_lnnorm=math.log(feh._norm), feh_halo_c=P.ONE_OVER_ROOT_2PI / 0.4, feh_halo_mu=-1.5,
                 feh_halo_var=0.4 ** 2, feh_disk_c=1.0 / 2.5066282746310007, feh_a1=0.8 / 0.15, feh_m1=0.016,
                 feh_v1=0.15 ** 2, feh_a2=0.2 / 0.22, feh_m2=-0.15, feh_v2=0.22 ** 2)
    on_av = type(av) in (P.AVPrior, P.FlatPrior)
    if on_av:
        lo, hi = _bounds(av)
        c.update(av_lo=lo, av_hi=hi, av_lnp=-math.log(hi - lo))
    comps = getattr(mass, "components", ())
    on_mass = (type(mass) in (P.ChabrierPrior, P.BrokenPrior) and len(comps) == 2 and len(mass.breakpoints) == 1
               and type(comps[0]) is P.LogNormalPrior and type(comps[1]) is P.PowerLawPrior)
    if on_mass:
        ln, pl = comps
        c.update(zip(("mass_lo", "mass_hi"), _bounds(mass)), mass_break=float(mass.breakpoints[0]),
                 mass_lnnorm0=float(mass.lognorms[0]), mass_lnnorm1=float(mass.lognorms[1]))
        c.update(zip(("ln_lo", "ln_hi"), _bounds(ln)), ln_lnnorm=math.log(ln._norm), ln_scale=ln.scale,
                 ln_log_s=ln.log_s, ln_sigma=ln.sigma, ln_mu=ln.mu, ln_c0=P.LOG_ONE_OVER_ROOT_2PI)
        c.update(zip(("pl_lo", "pl_hi"), _bounds(pl)), pl_lnc=math.log(pl._C()), pl_alpha=float(pl.alpha))
    c.update(eep_lo=float(eep_bounds[0]), eep_hi=float(eep_bounds[1]))
    c.update({f"los{k}": float(v) for k, v in enumerate(los)})
    # ln p(d) = ln 3 - 3 ln hi + 2 ln d, the first two per star
    dist = torch.stack([d_hi, math.log(3.0) - 3.0 * torch.log(d_hi)], dim=-1).contiguous()
    return CatalogPriors(consts=c, on=(on_age, on_feh, on_av, on_mass), dist=dist)


def _strict(x, lo, hi, ln):
    """BoundedPrior's bounds: -inf where x < lo or x > hi."""
    return torch.where((x < lo) | (x > hi), _NEG_INF, ln)


def _age_lnpdf(x, c):
    return _strict(x, c["age_lo"], c["age_hi"], c["age_lnln10"] + x * c["age_ln10"] - c["age_lnnorm"])


def _feh_lnpdf(x, c):
    def gauss(mu, var):
        return torch.exp(-0.5 * (x - mu) ** 2 / var)

    halo = c["feh_halo_c"] * gauss(c["feh_halo_mu"], c["feh_halo_var"])
    disk = c["feh_disk_c"] * (c["feh_a1"] * gauss(c["feh_m1"], c["feh_v1"]) + c["feh_a2"] * gauss(c["feh_m2"],
                                                                                                  c["feh_v2"]))
    pdf = c["feh_halo"] * halo + c["feh_disk"] * disk
    return _strict(x, c["feh_lo"], c["feh_hi"], torch.log(torch.clamp(pdf, min=1e-300)) - c["feh_lnnorm"])


def _av_lnpdf(x, c):
    return _strict(x, c["av_lo"], c["av_hi"], torch.full_like(x, c["av_lnp"]))


def _mass_lnpdf(x, c):
    y = x / c["ln_scale"]
    lg = torch.log(torch.clamp(y, min=1e-300))
    ln0 = c["ln_c0"] - (c["ln_log_s"] + lg) - 0.5 * (lg / c["ln_sigma"]) ** 2 - c["ln_mu"]
    ln0 = torch.where(y > 0, ln0, _NEG_INF) - c["ln_lnnorm"]
    inb = torch.ones_like(x, dtype=torch.bool)  # Prior's inclusive bounds, where finite
    if np.isfinite(c["ln_lo"]):
        inb = inb & (x >= c["ln_lo"])
    if np.isfinite(c["ln_hi"]):
        inb = inb & (x <= c["ln_hi"])
    ln0 = torch.where(inb, ln0, _NEG_INF)
    ln1 = _strict(x, c["pl_lo"], c["pl_hi"], c["pl_lnc"] + c["pl_alpha"] * torch.log(torch.clamp(x, min=1e-300)))
    # a NaN counts as above the breakpoint
    ln = torch.where(~(x < c["mass_break"]), ln1 - c["mass_lnnorm1"], ln0 - c["mass_lnnorm0"])
    return _strict(x, c["mass_lo"], c["mass_hi"], ln)


def unit_box(u: torch.Tensor, pri: CatalogPriors, his: torch.Tensor) -> torch.Tensor:
    """The nested fit's box map ``los + (his - los) * u`` for unit-cube points
    (S, B, 5) and box tops ``his`` (S, 5)."""
    los = torch.tensor([pri.consts[f"los{k}"] for k in range(5)], dtype=u.dtype, device=u.device)
    return los + (his[:, None, :] - los) * u


def catalog_lnpost_plain(x: torch.Tensor, lk: CatalogLikelihood, pri: CatalogPriors,
                         his: Optional[torch.Tensor] = None):
    """(S, B, 5) parameters, or unit-cube points with the box tops ``his``
    (S, 5) -> ``(lnpost (S, B), orig_val (S, B) or None)`` in plain torch ops,
    on any device; ``orig_val`` only when the mass prior's flag is off."""
    pars = x if his is None else unit_box(x, pri, his)
    c = pri.consts
    ll, orig, deriv = catalog_lnlike_plain(pars, lk)
    on_age, on_feh, on_av, on_mass = pri.on
    lnp = torch.zeros_like(ll)
    if on_age:
        lnp = lnp + _age_lnpdf(pars[..., 1], c)
    if on_feh:
        lnp = lnp + _feh_lnpdf(pars[..., 2], c)
    if on_av:
        lnp = lnp + _av_lnpdf(pars[..., 4], c)
    d = pars[..., 3]
    d_hi, lnp_d0 = pri.dist[:, None, 0], pri.dist[:, None, 1]
    # the 1e-300 floors flush to 0 in float32, as in the JAX package; the
    # masks decide those points
    lnp_d = lnp_d0 + 2.0 * torch.log(torch.clamp(d, min=1e-300))
    lnp = lnp + torch.where((d > 0) & (d < d_hi), lnp_d, _NEG_INF)
    eep_term = torch.log(torch.clamp(deriv, min=1e-300))
    if on_mass:
        eep_term = _mass_lnpdf(orig, c) + eep_term
    eep_term = torch.where(torch.isfinite(orig) & (deriv > 0), eep_term, _NEG_INF)
    eep_term = torch.where((pars[..., 0] < c["eep_lo"]) | (pars[..., 0] > c["eep_hi"]), _NEG_INF, eep_term)
    lnp = lnp + eep_term
    ll = torch.where(torch.isnan(ll), _NEG_INF, ll)
    return torch.where(torch.isfinite(lnp), lnp + ll, _NEG_INF), (None if on_mass else orig)


def catalog_lnpost(x: torch.Tensor, lk: CatalogLikelihood, pri: CatalogPriors, his: Optional[torch.Tensor] = None):
    """The catalog posterior: CPU tensors take :func:`catalog_lnpost_plain`,
    CUDA tensors the kernel (one launch)."""
    kind = x.device.type
    if kind == "cuda":
        from .catalog_cuda import catalog_lnpost_cuda

        return catalog_lnpost_cuda(x, lk, pri, his)
    if kind == "cpu":
        return catalog_lnpost_plain(x, lk, pri, his)
    raise ValueError(f"catalog_lnpost runs on cpu or cuda tensors, got {kind}")
