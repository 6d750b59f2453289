"""Hand-written CUDA kernel for the hierarchical-cluster marginal likelihood.

Replaces the Pallas TPU kernel ``isochrones_tpu/ops/cluster_pallas.py``
(``_cluster_kernel`` and its wrapper ``cluster_lnmarginal_pallas``); the
source is ``isochrones_torch/csrc/cluster_marginal.cu``, whose header says
what bounds it on the card (special-function and FMA throughput) and how the
design answers that. The plain version it replaces sits beside it in
:mod:`isochrones_torch.ops.cluster`.

The kernel takes every walker of a batch in one launch. This wrapper does
the O(W*(E*B + S*E)) preparation in torch (flux, mass prior, row term,
per-walker scalars) and leaves all O(S*E^2) work to the kernel, which
computes the q prior, the mask and the trapezoid weight of each cell itself
(the closed form of :func:`trapezoid_weights`), so no (E, E) plane is built.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library

__all__ = ["trapezoid_weights", "cluster_lnmarginal_cuda"]


def trapezoid_weights(eeps, mask):
    """(Neep, Neep) weights W such that for any per-star plane L,

        exp(integrate_over_eeps_ln(where(mask, L, -inf), eeps))
          == sum_{j,k} exp(L[j,k]) * W[j,k]

    ``w_outer[j] * w_inner[j, k]`` from ``de[k-1]`` and ``de[k]``; the
    kernel evaluates the same closed form per cell."""
    n = eeps.shape[0]
    de = eeps[1:] - eeps[:-1]
    zero = torch.zeros(1, dtype=eeps.dtype, device=eeps.device)
    de_km1 = torch.cat([zero, de])  # de[k-1], with de[-1] = 0
    de_k = torch.cat([de, zero])  # de[k], with de[n-1] = 0
    j = torch.arange(n, device=eeps.device)[:, None]
    k = torch.arange(n, device=eeps.device)[None, :]
    w_inner = 0.5 * (de_k[None, :] * (k + 1 <= j) + de_km1[None, :] * (k <= j))
    w_outer = 0.5 * (de_km1 + de_k)
    return torch.where(mask, w_outer[:, None] * w_inner, torch.zeros((), dtype=eeps.dtype, device=eeps.device))


_P = ctypes.c_void_p
_ARGTYPES = [_P] * 11 + [ctypes.c_double] + [ctypes.c_int] * 5 + [_P] * 4


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel library with every entry point's C signature declared."""
    lib = load_library()
    for name in ("cluster_marginal_f32", "cluster_marginal_f64"):
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    lib.cluster_marginal_num_jtiles.argtypes = [ctypes.c_int]
    lib.cluster_marginal_num_jtiles.restype = ctypes.c_int
    lib.cluster_marginal_max_bands.argtypes = []
    lib.cluster_marginal_max_bands.restype = ctypes.c_int
    lib.cluster_marginal_error_string.argtypes = [ctypes.c_int]
    lib.cluster_marginal_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, shape, dtype, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def cluster_lnmarginal_cuda(
    lnlike_prop,  # (W, S, E)
    model_mags,  # (W, E, B)
    masses,  # (W, E)
    ln_dm_deeps,  # (W, E)
    eeps,  # (E,)
    mag_values,  # (S, B)
    mag_uncs,  # (S, B)
    alpha,  # (W,)
    gamma,  # (W,)
    fB,  # (W,)
    mass_lo,
    mass_hi,
    q_lo,
    valid,  # (W, E) bool
    *,
    q_jacobian=False,
    valid_k=None,  # (W, E) bool; defaults to ``valid``
):
    """(W, S) ln marginals from one kernel launch (plus its small combine
    pass); -inf where a star has no support. Raises on anything the kernel
    does not take, and if the launch fails."""
    W, S, E = lnlike_prop.shape
    dt, dev = lnlike_prop.dtype, lnlike_prop.device
    if dev.type != "cuda":
        raise ValueError(f"cluster_lnmarginal_cuda needs CUDA tensors, got {dev}")
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"cluster_lnmarginal_cuda takes float32 or float64, got {dt}")
    B = model_mags.shape[-1]
    if valid_k is None:
        valid_k = valid
    _check("model_mags", model_mags, (W, E, B), dt, dev)
    for name, t in (("masses", masses), ("ln_dm_deeps", ln_dm_deeps)):
        _check(name, t, (W, E), dt, dev)
    _check("eeps", eeps, (E,), dt, dev)
    _check("mag_values", mag_values, (S, B), dt, dev)
    _check("mag_uncs", mag_uncs, (S, B), dt, dev)
    for name, t in (("alpha", alpha), ("gamma", gamma), ("fB", fB)):
        _check(name, t, (W,), dt, dev)
    _check("valid", valid, (W, E), torch.bool, dev)
    _check("valid_k", valid_k, (W, E), torch.bool, dev)
    lib = _lib()
    if not 1 <= B <= lib.cluster_marginal_max_bands():
        raise ValueError(f"cluster kernel takes 1..{lib.cluster_marginal_max_bands()} bands, got {B}")
    if W * S == 0:
        return torch.empty((W, S), dtype=dt, device=dev)
    if E == 0:
        raise ValueError("cluster kernel needs a non-empty EEP ladder")

    either = valid | valid_k
    safe_mags = torch.where(either[..., None], model_mags, torch.zeros_like(model_mags))
    flux = (10.0 ** (-0.4 * safe_mags)).transpose(1, 2).contiguous()  # (W, B, E)
    mags_t = safe_mags.transpose(1, 2).contiguous()  # (W, B, E)

    a1 = alpha + 1.0
    c_mass = a1 / (mass_hi ** a1 - mass_lo ** a1)
    lnmass = torch.log(c_mass)[:, None] + alpha[:, None] * torch.log(masses) + ln_dm_deeps  # (W, E)
    g1 = gamma + 1.0
    ln_cq = torch.log(g1 / (1.0 - q_lo ** g1))
    params = torch.stack([torch.log(fB), torch.log1p(-fB), gamma, ln_cq], dim=-1).contiguous()  # (W, 4)
    lnprop = torch.nan_to_num(lnlike_prop, nan=-1e30, neginf=-1e30)
    lnjrow = (lnprop + lnmass[:, None, :]).contiguous()  # (W, S, E)

    masses_c = masses.contiguous()
    ln_dm_c = ln_dm_deeps.contiguous()
    valid_u8 = valid.to(torch.uint8).contiguous()
    valid_k_u8 = valid_k.to(torch.uint8).contiguous()
    eeps_c = eeps.contiguous()
    magv = mag_values.contiguous()
    magu = mag_uncs.contiguous()

    n_jt = lib.cluster_marginal_num_jtiles(E)
    part_m = torch.empty((W, S, n_jt), dtype=dt, device=dev)
    part_s = torch.empty((W, S, n_jt), dtype=dt, device=dev)
    out = torch.empty((W, S), dtype=dt, device=dev)

    fn = lib.cluster_marginal_f32 if dt == torch.float32 else lib.cluster_marginal_f64
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            flux.data_ptr(), mags_t.data_ptr(), masses_c.data_ptr(), ln_dm_c.data_ptr(),
            valid_u8.data_ptr(), valid_k_u8.data_ptr(), lnjrow.data_ptr(), eeps_c.data_ptr(),
            magv.data_ptr(), magu.data_ptr(), params.data_ptr(),
            float(q_lo), int(bool(q_jacobian)), W, S, E, B,
            part_m.data_ptr(), part_s.data_ptr(), out.data_ptr(), stream,
        )
    if err != 0:
        msg = lib.cluster_marginal_error_string(err).decode()
        raise RuntimeError(f"cluster_marginal kernel launch failed: {msg} ({err})")
    cluster_lnmarginal_cuda.launches += 1
    return out


#: kernel launches made through this wrapper (reset by callers that count)
cluster_lnmarginal_cuda.launches = 0
