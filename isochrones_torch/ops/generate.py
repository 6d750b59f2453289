"""The forward model: plain PyTorch version and dispatcher.

Counterpart of the JAX package's fused forward model, ``_generate_g``
(``isochrones_tpu/models/interpolator.py:109-156``), which XLA compiles into
one program: for points ``(mass, age, feh, distance, AV)`` on an evolution
track grid it inverts (mass, age, feh) to an EEP (:func:`~.eep.interp_eep`;
with ``accurate``, refined by :func:`~.eep.get_eep_newton` and NaN where the
residual is ``resid_tol`` or more), interpolates the chosen model columns at
(mass, EEP, feh), and forms the magnitudes ``Mbol + 5 log10(d / 10) - BC``
(:func:`~.mags.interp_mag_plain`); with ``all_As`` the magnitudes again at AV = 0.
Given EEPs skip the inversion.

:func:`generate_plain` composes the port's ``ops/eep.py``, ``ops/interp.py``
and ``ops/mags.py``; the tests and the card's checks use it.
:func:`generate_forward`, :func:`get_eep_fast`, :func:`get_eep_accurate`
(a track grid's accurate inversion) and :func:`eep_newton` (the Newton step
from given seeds on any :class:`NewtonGrid`, an isochrone grid's inversion)
dispatch on the device: a CPU tensor takes the plain version, a CUDA tensor
the hand-written kernel (:mod:`isochrones_torch.ops.generate_cuda`), one
launch a call, the accurate forms' Newton step included, with no fallback
between them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .eep import get_eep_newton, interp_eep
from .interp import GridData, interp_nd_plain
from .mags import interp_mag_plain

__all__ = ["ForwardModel", "NewtonGrid", "generate_plain", "generate_forward", "get_eep_fast", "get_eep_accurate",
           "eep_newton"]


@dataclasses.dataclass(frozen=True, eq=False)
class ForwardModel:
    """What the forward model needs besides the points, on one device in one
    dtype: an evolution-track interpolator's tables."""

    model: GridData  # (feh, mass, eep) -> every column
    model_packed: GridData  # the (Teff, logg, feh, Mbol) columns of ``model``
    bc: GridData  # (Teff, logg, feh, AV) -> bands
    eep_support: Tuple[torch.Tensor, ...]  # feh knots, mass knots, (n_feh * n_mass, n_eep) ages (+inf padded), lengths
    index_order: Tuple[int, ...]  # (mass, eep, feh, distance, AV) -> (grid axes 0..2, distance, AV)
    model_icols: Tuple[int, int, int, int]  # Teff, logg, feh, Mbol in ``model``
    eep0: float  # the first EEP knot
    i_age: int  # the age column of ``model``


@dataclasses.dataclass(frozen=True, eq=False)
class NewtonGrid:
    """A 3-d model grid whose last axis is the EEP, and the column that the
    accurate inversion matches (an isochrone grid's initial mass)."""

    grid: GridData
    icol: int


def _cut(eep, resid, resid_tol):
    return torch.where(resid.abs() < resid_tol, eep, torch.full_like(eep, float("nan")))


def _newton(fm: ForwardModel, fast, mass, age, feh, resid_tol):
    return _cut(*get_eep_newton(fm.model, fast, age, feh, mass, fm.i_age), resid_tol)


def generate_plain(fm: ForwardModel, mass, age, feh, distance, AV, prop_icols, band_icols,
                   eeps: Optional[torch.Tensor] = None, all_As=False, accurate=False, resid_tol=0.02):
    """``(eeps, props (N, P), mags (N, n_bands), mags at AV = 0 or None)`` for
    1-d tensors of N points, in plain torch ops on any device."""
    if eeps is None:
        eeps = interp_eep(age, feh, mass, *fm.eep_support, eep0=fm.eep0)
        if accurate:
            eeps = _newton(fm, eeps, mass, age, feh, resid_tol)
    pts5 = torch.stack(torch.broadcast_tensors(mass, eeps, feh, distance, AV), dim=-1)
    io = fm.index_order
    grid_pts = torch.stack([pts5[..., io[0]], pts5[..., io[1]], pts5[..., io[2]]], dim=-1)
    props = interp_nd_plain(fm.model.values, fm.model.knots, grid_pts, icols=tuple(prop_icols),
                      axis_maps=fm.model.axis_maps)
    packed = (0, 1, 2, 3)
    mags = interp_mag_plain(pts5, io, fm.model_packed, packed, fm.bc, tuple(band_icols))[3]
    mags0 = None
    if all_As:
        pts0 = torch.cat([pts5[..., :4], torch.zeros_like(pts5[..., 4:])], dim=-1)
        mags0 = interp_mag_plain(pts0, io, fm.model_packed, packed, fm.bc, tuple(band_icols))[3]
    return eeps, props, mags, mags0


def _device_kind(x: torch.Tensor, name: str) -> str:
    kind = x.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, got {kind}")
    return kind


def generate_forward(fm: ForwardModel, mass, age, feh, distance, AV, prop_icols, band_icols,
                     eeps: Optional[torch.Tensor] = None, all_As=False, accurate=False, resid_tol=0.02):
    """The forward model: CPU tensors take :func:`generate_plain`, CUDA
    tensors the kernel (one launch, ``accurate`` or not). Same arguments and
    results."""
    if _device_kind(mass, "generate_forward") == "cpu":
        return generate_plain(fm, mass, age, feh, distance, AV, prop_icols, band_icols, eeps=eeps, all_As=all_As,
                              accurate=accurate, resid_tol=resid_tol)
    from .generate_cuda import generate_accurate_cuda, generate_cuda

    if eeps is None and accurate:
        return generate_accurate_cuda(fm, mass, age, feh, distance, AV, prop_icols, band_icols, all_As=all_As,
                                      resid_tol=resid_tol)
    return generate_cuda(fm, mass, age, feh, distance, AV, prop_icols, band_icols, eeps=eeps, all_As=all_As)


def get_eep_fast(fm: ForwardModel, mass, age, feh):
    """The fast EEP inversion of broadcast tensors of any one shape: CPU
    tensors take :func:`~.eep.interp_eep`, CUDA tensors the kernel's EEP-only
    form (one launch)."""
    if _device_kind(mass, "get_eep_fast") == "cpu":
        return interp_eep(age, feh, mass, *fm.eep_support, eep0=fm.eep0)
    from .generate_cuda import get_eep_cuda

    shape = mass.shape
    return get_eep_cuda(fm, mass.reshape(-1), age.reshape(-1), feh.reshape(-1)).reshape(shape)


def get_eep_accurate(fm: ForwardModel, mass, age, feh, resid_tol=0.02):
    """The accurate EEP inversion on a track grid, of broadcast tensors of
    any one shape: the fast estimate refined by the Newton step on the age
    column, NaN where its residual is ``resid_tol`` or more. CPU tensors take
    :func:`~.eep.interp_eep` and :func:`~.eep.get_eep_newton`, CUDA tensors
    the kernel (one launch)."""
    if _device_kind(mass, "get_eep_accurate") == "cpu":
        return _newton(fm, interp_eep(age, feh, mass, *fm.eep_support, eep0=fm.eep0), mass, age, feh, resid_tol)
    from .generate_cuda import get_eep_accurate_cuda

    shape = mass.shape
    return get_eep_accurate_cuda(fm, mass.reshape(-1), age.reshape(-1), feh.reshape(-1), resid_tol).reshape(shape)


def eep_newton(ng: NewtonGrid, seed, target, x0, x1, resid_tol=0.02):
    """:func:`~.eep.get_eep_newton` of column ``ng.icol`` from ``seed`` at
    grid coordinates ``(x0, x1, eep)`` then the ``resid_tol`` cut, on
    broadcast tensors of any one shape: CPU tensors take the plain version,
    CUDA tensors the kernel's Newton form (one launch)."""
    if _device_kind(target, "eep_newton") == "cpu":
        return _cut(*get_eep_newton(ng.grid, seed, target, x0, x1, ng.icol), resid_tol)
    from .generate_cuda import eep_newton_cuda

    shape = target.shape
    return eep_newton_cuda(ng, *(x.reshape(-1) for x in (seed, target, x0, x1)), resid_tol=resid_tol).reshape(shape)
