"""The yardstick of the kernels' rooflines: the card's peaks and the work each
kernel's call needs, counted from the call's inputs with plain torch.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, at its 700 W limit):
3.35e12 bytes/s of HBM3, 67e12 float32 and 34e12 float64 flop/s outside the
tensor cores (an FMA counts 2 flops). A special function (exp, log, log10,
a power of 10) is counted as a fixed number of flops of its dtype, whatever
implements it, so that the work does not change when a kernel changes how
it computes one: :data:`SPECIAL_FLOPS`. In float64 the card has no
special-function unit: an exp or a log is a range reduction and a polynomial
of about ten FMAs on the FP64 pipe, 20 flops. In float32 one special is one
issue of the special-function unit, whose rate is an eighth of the FMA rate,
so 16 flops.
"""

from __future__ import annotations

import torch

from .reference.interp import interp, locate

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}
SPECIAL_FLOPS = {torch.float32: 16, torch.float64: 20}


def bound_s(nbytes, flops, specials, dtype):
    """``(seconds, what)``: the least time the card could take for this
    work, and whether bytes or operations set it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (flops + specials * SPECIAL_FLOPS[dtype]) / FLOPS_PER_S[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cluster_cells(masses, finite, valid, eeps, qlo):
    """Cells ``(j, k)`` of the walkers' (EEP1, EEP2) planes that carry
    weight: ``k <= j``, row ``j`` valid, row ``k`` finite, ``m_k / m_j >=
    qlo`` and a positive trapezoid weight. ``masses``, ``finite``, ``valid``
    (W, E) are the ladder rows of :func:`portbench.reference.cluster.ladder_rows`."""
    E = eeps.shape[0]
    de = eeps[1:] - eeps[:-1]
    zero = torch.zeros(1, dtype=eeps.dtype, device=eeps.device)
    de_k, de_km1 = torch.cat([de, zero]), torch.cat([zero, de])
    j = torch.arange(E, device=eeps.device)[:, None]
    k = torch.arange(E, device=eeps.device)[None, :]
    weight = ((k + 1 <= j) & (de_k[None, :] > 0)) | ((k <= j) & (de_km1[None, :] > 0))
    weight &= (0.5 * (de_km1 + de_k) > 0)[:, None]
    m = torch.where(finite, masses, torch.ones_like(masses))
    n = 0
    for w in range(masses.shape[0]):
        q = m[w][None, :] / m[w][:, None]
        n += int((weight & valid[w][:, None] & finite[w][None, :] & (q >= qlo)).sum())
    return n


def cluster_work(n_cells, W, S, E, B, itemsize):
    """``(bytes, flops, specials)`` of one call of the cluster marginal over
    ``W`` walkers, ``S`` members, an ``E``-row ladder and ``B`` bands with
    ``n_cells`` weighted cells in all. Bytes: each input read once (the
    per-walker flux and magnitudes (W, B, E), masses, ln|dm/dEEP| and two row
    masks (W, E), the row term (W, S, E), the ladder, the members' magnitudes
    and errors, four scalars a walker) and the (W, S) marginals written.
    Per weighted cell the least arithmetic: per (member, band) one exp and 10
    flops (two residual FMAs, a max, a sum, a difference, a product), per
    member one exp and 5 flops (the shifted sum), per band one log10 and 3
    flops (the binary's magnitude)."""
    nbytes = itemsize * (2 * W * B * E + 2 * W * E + W * S * E + E + 2 * S * B + 4 * W + W * S) + 2 * W * E
    flops = n_cells * (S * B * 10 + S * 5 + B * 3)
    specials = n_cells * (S * (B + 1) + B)
    return nbytes, flops, specials


def _touched_rows(values, knots, pts):
    """Distinct table rows that the corners of the in-bounds points read."""
    ndim, dims = len(knots), values.shape[:-1]
    flat = torch.zeros((pts.shape[0], 2 ** ndim), dtype=torch.int64, device=pts.device)
    corner = torch.arange(2 ** ndim, device=pts.device)
    bad = torch.zeros(pts.shape[0], dtype=torch.bool, device=pts.device)
    for d in range(ndim):
        cell, _, b = locate(knots[d], pts[:, d])
        bad |= b
        up = (corner >> (ndim - 1 - d)) & 1
        flat = flat * dims[d] + torch.clamp(cell[:, None] + up, max=dims[d] - 1)
    return int(torch.unique(flat[~bad]).numel())


def catalog_work(x, tables, n_bands, terms, itemsize):
    """``(bytes, flops, specials)`` of one catalogue-posterior call at the
    parameters ``x`` (S, N, 5). Bytes: the points read and the posterior
    written once, each distinct isochrone row the points' corners touch read
    once (its 6 packed columns: Teff, logg, [Fe/H], Mbol, initial mass,
    dm/dEEP), each distinct BC row their (Teff, logg, [Fe/H], AV) corners
    touch (its ``n_bands`` columns), each star's observation and distance
    rows once. Per point ~70 flops of cell location, 8 corners x 18, 16
    corners x (8 + 2 a band), 3 a band for the magnitudes, 6 a Gaussian term
    (``terms`` (S,): each star's observations that are not missing), and 60
    for the priors; specials: the distance modulus's log10, a log a Gaussian
    term, and the priors' 8 (three exp and a log for
    [Fe/H], logs of the distance, the log-normal, the power law and the
    derivative)."""
    S, N = x.shape[:2]
    values, knots, columns = tables["iso"]
    ci = {c: i for i, c in enumerate(columns)}
    pts = x.reshape(S * N, 5)
    gp = torch.stack([pts[:, 1], pts[:, 2], pts[:, 0]], dim=-1)
    tlf = interp(values, knots, gp, [ci["Teff"], ci["logg"], ci["feh"]])
    bvals, bknots, _ = tables["bc"]
    bp = torch.cat([tlf, pts[:, 4:5]], dim=-1)
    rows = 6 * _touched_rows(values, knots, gp) + n_bands * _touched_rows(bvals, bknots, bp)
    nbytes = itemsize * (pts.numel() + S * N + rows + S * (8 + 2 * n_bands))
    n_terms = int(sum(terms))
    flops = N * (S * (70 + 8 * 18 + 16 * (8 + 2 * n_bands) + 3 * n_bands + 60) + 6 * n_terms)
    specials = N * (S * (1 + 8) + n_terms)
    return nbytes, flops, specials
