"""Nested sampling on one device, static or dynamic, with checkpoint and
resume: a single run, ``n_runs`` independent runs of one problem, or a family
of problems with their own data.

Counterpart of ``isochrones_tpu/samplers/nested.py``: the sampler explores
the unit cube, maps it through a ``prior_transform`` and treats the model's
lnpost as the nested-sampling log-likelihood, so evidences and equal-weight
posteriors follow the MultiNest conventions of the reference.

Each step removes the ``n_batch`` worst live points and replaces them with
constrained random walks (L > L*) from random survivors: ``n_chains`` chains
per replacement, whitened by the live-point covariance, with a step scale
that adapts toward 35% acceptance. The JAX ``lax.scan`` loops become Python
loops of device ops: the walk scale, the acceptance counts and the live set
stay on the device, every draw comes from one ``torch.Generator``, and the
host reads back only once per chunk of dead points (termination check and
dead-point storage). Weights and evidence are assembled on the host with the
same numpy code as the JAX package.

With ``dynamic=True`` a base run that meets the evidence criterion with too
few effective samples is followed by posterior-focused thread runs, merged
through the varying-live-count schedule (:func:`_merge_segments`). With
``checkpoint`` the whole loop-carried state, the ``torch.Generator``'s
included, is written at every chunk and thread-round boundary; a resumed run
is bitwise the run that never stopped (same device, same dtype).

One engine (:func:`_run_family`) runs every one of them as a family of
problems in lockstep, a leading problem axis M on every op of its steps
(:class:`_FamilySteps`): a single run is a family of one, ``n_runs=M`` a
family of ``M`` copies of one likelihood, :func:`run_nested_vmapped` ``M``
problems with their own data (a whole catalog of stars). Each walk step is one
likelihood call over ``(M, B, p)`` points, so the number of launches per step
does not grow with M. On a CUDA device without
a mesh, :func:`run_nested_vmapped` replays its second and later steps as one
CUDA graph (``_FamilySteps(graphed=True)``): the same kernels and the same
draws as the eager steps, launched once a step, so the host no longer sets the
pace of the walk's few hundred small launches.

With ``mesh`` (an :class:`~isochrones_torch.parallel.Mesh`) the likelihood
fan-out is split over the mesh's shards: the walk batch of a single run, the
run axis of ``n_runs > 1``, the problem axis of :func:`run_nested_vmapped`.
The live sets, the walk scales and the generator stay on the mesh's first
device, so a sharded run is the unsharded one wherever the likelihood's
arithmetic for one point does not depend on the batch.
"""

from __future__ import annotations

import os
import pickle
import sys
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..logger import getLogger
from ..tracing import span, spanned

__all__ = ["CheckpointConfigError", "NestedResult", "run_nested", "run_nested_vmapped"]


class NestedResult(NamedTuple):
    samples: np.ndarray  # (n_dead + n_live, n_params) in PARAMETER space
    logl: np.ndarray  # (n_dead + n_live,)
    logwt: np.ndarray  # (n_dead + n_live,) unnormalized ln(prior mass * L)
    logz: float
    logzerr: float
    h: float  # information
    n_iter: int
    posterior: np.ndarray  # equal-weight posterior samples (n_eq, n_params)
    logl_posterior: np.ndarray  # lnpost values for the equal-weight samples
    ess: float = np.nan  # effective sample size of the posterior weights
    truncated: bool = False  # ESS still below min_ess when the budget ran out
    logz_runs: np.ndarray = None  # per-run evidences (n_runs > 1)
    dynamic_rounds: int = 0  # posterior-bulk thread rounds run (dynamic=True)


# ---------------------------------------------------------------- host assembly
# The numpy functions below are the JAX package's own (samplers/nested.py
# :48-284, :337-349, :373-385), so the two packages weigh the same dead
# points alike.


def _ln_x_schedule(n_dead: int, n_live: int, n_batch: int = 1) -> np.ndarray:
    """E[ln X_i] for each dead point under batched-K removal: the j-th
    removal of a batch (0-based, ascending lnL) shrinks the prior mass by
    1/(n_live - j)."""
    return -np.cumsum(_ln_x_increments(np.arange(n_dead), n_live, n_batch))


def _ln_x_increments(idx, n_live: int, n_batch: int = 1):
    """Per-removal |E[d ln X]| for dead-point indices ``idx``: 1/(n_live - j)
    at in-batch position j."""
    return 1.0 / (n_live - (np.asarray(idx) % n_batch))


def _logzerr_scale(n_live: int, n_batch: int = 1) -> float:
    """Effective 1/n of ``logzerr = sqrt(H / n)`` under batched-K removal:
    <1/n_j^2> / <1/n_j> over the in-batch positions."""
    j = np.arange(n_batch, dtype=float)
    inv = 1.0 / (n_live - j)
    return float(np.sum(inv ** 2) / np.sum(inv))


def _assemble_weights(dead_lnl: np.ndarray, live_lnl: np.ndarray, n_live: int, n_batch: int = 1):
    """Skilling (2006) prior-mass weights for dead + final live points.
    Returns ``(order, all_lnl, all_logwt, logz, probs, ess)``; ``order``
    sorts the live points by lnL (their storage order in the outputs)."""
    n_dead = len(dead_lnl)
    ln_x = _ln_x_schedule(n_dead, n_live, n_batch)
    ln_x_prev = np.concatenate([[0.0], ln_x[:-1]])
    w = np.exp(ln_x_prev) - np.exp(ln_x)
    logwt_dead = np.log(np.maximum(w, 1e-300)) + dead_lnl

    order = np.argsort(live_lnl)
    x_final = np.exp(ln_x[-1]) if n_dead else 1.0
    logwt_live = np.log(x_final / n_live) + live_lnl[order]

    all_lnl = np.concatenate([dead_lnl, live_lnl[order]])
    all_logwt = np.concatenate([logwt_dead, logwt_live])
    logz, probs, ess = _evidence_from_logwt(all_logwt)
    return order, all_lnl, all_logwt, logz, probs, ess


def _assemble(dead_u, dead_lnl, live_u, live_lnl, n_live, n_batch):
    """One problem's static run assembled as :func:`_merge_segments`
    assembles a dynamic one: ``(all_u, all_lnl, all_logwt, logz, probs, ess,
    h, logzerr)``, with ``logzerr = sqrt(H / n)`` under batched-K removal."""
    order, all_lnl, all_logwt, logz, probs, ess = _assemble_weights(dead_lnl, live_lnl, n_live, n_batch=n_batch)
    all_u = np.concatenate([dead_u, live_u[order]], axis=0)
    finite = np.isfinite(all_logwt)
    p = np.exp(all_logwt[finite] - logz)
    h = float(np.sum(p * (all_lnl[finite] - logz)))
    logzerr = float(np.sqrt(max(h, 0.0) * _logzerr_scale(n_live, n_batch)))
    return all_u, all_lnl, all_logwt, logz, probs, ess, h, logzerr


def _evidence_from_logwt(all_logwt):
    """(logz, normalized posterior probs, ESS) from unnormalized ln-weights."""
    finite = np.isfinite(all_logwt)
    lw = all_logwt[finite]
    lmax = lw.max() if len(lw) else 0.0
    logz = float(lmax + np.log(np.exp(lw - lmax).sum())) if len(lw) else -np.inf
    probs = np.zeros(len(all_logwt))
    probs[finite] = np.exp(lw - logz)
    psum = probs.sum()
    if psum > 0:
        probs = probs / psum
    ess = float(1.0 / np.sum(probs ** 2)) if psum > 0 else 0.0
    return logz, probs, ess


def _merge_segments(segments):
    """Varying-live-count weight assembly for a base run merged with
    posterior-focused thread runs: dynamic nested sampling (Higson et al.
    2019; the machinery behind dynesty's ``merge_runs``), generalized to this
    engine's batched-K removal.

    Statistical picture: every segment's live points are uniform draws in the
    prior constrained above that segment's activation threshold ``L0``, so at
    any likelihood level the union of alive points across segments is uniform
    in the common constrained prior. Processing all deaths in ascending-lnL
    order, each death shrinks the prior mass by ``E[ln t] = -1/n_alive``
    where ``n_alive`` counts alive points from every active segment: the
    single-segment case reproduces :func:`_ln_x_increments` exactly (batched-K
    removal decrements within a batch and refills K at the batch boundary).
    Final live points are consumed as decrementing deaths (the standard
    varying-n treatment).

    segments : list of dicts with keys ``dead_lnl`` (ascending), ``live_lnl``,
        ``all_u`` (dead_u + live_u[argsort(live_lnl)] stacked), ``n_live``,
        ``n_batch``, ``L0`` (activation threshold; -inf for the base run).

    Returns ``(all_u, all_lnl, all_logwt, logz, probs, ess, h, logzerr)``
    with rows in ascending-lnL merged order.
    """
    lnls, prios, seg_ids, kinds, refills, srcs = [], [], [], [], [], []
    for s, seg in enumerate(segments):
        dead = np.asarray(seg["dead_lnl"], dtype=float)
        m = len(dead)
        K = max(1, int(seg.get("n_batch", 1)))
        j = np.arange(m)
        # deaths (kind 1): refill K live points at each batch boundary
        lnls.append(dead)
        prios.append(np.ones(m))
        seg_ids.append(np.full(m, s))
        kinds.append(np.ones(m))
        refills.append(np.where(j % K == K - 1, K, 0))
        srcs.append(j)
        # final live points (kind 2), ascending
        live = np.asarray(seg["live_lnl"], dtype=float)
        lo = np.argsort(live)
        n = len(live)
        lnls.append(live[lo])
        prios.append(np.full(n, 2.0))
        seg_ids.append(np.full(n, s))
        kinds.append(np.full(n, 2))
        refills.append(np.zeros(n))
        srcs.append(m + np.arange(n))
        # activation (kind 0): n_live points come alive above L0. prio 0 -
        # FIRST at its lnl: the base activation at -inf must precede any
        # -inf death (else a divide-by-zero on pathological likelihoods the
        # static path handles), and a thread's own events tied exactly at
        # L0 must see their segment's points alive. The cost is the
        # measure-zero boundary case of a base death tied exactly at L0
        # counting the thread's points: a 1/(n+m)-vs-1/n difference on one
        # event.
        lnls.append(np.array([seg["L0"]]))
        prios.append(np.array([0.0]))
        seg_ids.append(np.array([s]))
        kinds.append(np.array([0.0]))
        refills.append(np.array([seg["n_live"]]))
        srcs.append(np.array([-1]))

    lnl = np.concatenate(lnls)
    prio = np.concatenate(prios)
    seg_id = np.concatenate(seg_ids).astype(int)
    kind = np.concatenate(kinds).astype(int)
    refill = np.concatenate(refills).astype(int)
    src = np.concatenate(srcs).astype(int)
    order = np.lexsort((prio, lnl))  # ascending lnl; activation < death < live

    # vectorized alive-count accounting: per-event alive delta, prefix-summed
    lnl_s = lnl[order]
    kind_s = kind[order]
    refill_s = refill[order]
    delta = np.where(kind_s == 0, refill_s, refill_s - 1)  # live: refill 0 -> -1
    alive_after = np.cumsum(delta)
    alive_before = alive_after - delta
    is_sample = kind_s != 0
    n_at = alive_before[is_sample].astype(float)
    if not len(n_at) or n_at.min() < 1:
        raise ValueError("merge saw a death/live event with no alive points")
    ln_x = -np.cumsum(1.0 / n_at)
    ln_x_prev = np.concatenate([[0.0], ln_x[:-1]])
    w = np.exp(ln_x_prev) - np.exp(ln_x)
    with np.errstate(invalid="ignore"):
        all_logwt = np.log(np.maximum(w, 1e-300)) + lnl_s[is_sample]
    all_logwt = np.where(np.isfinite(all_logwt), all_logwt, -np.inf)
    all_lnl = lnl_s[is_sample]

    rows = order[is_sample]
    all_u = np.empty((len(rows), segments[0]["all_u"].shape[-1]))
    for s, seg in enumerate(segments):
        m = seg_id[rows] == s
        all_u[m] = seg["all_u"][src[rows[m]]]

    logz, probs, ess = _evidence_from_logwt(all_logwt)
    # information + error: the constant-n sqrt(H/n) generalizes to
    # sqrt(sum_i p_i (lnL_i - ln Z) / n_i) under varying live counts
    with np.errstate(invalid="ignore"):
        h_terms = probs * (all_lnl - logz)
    h = float(np.nansum(h_terms))
    logzerr = float(np.sqrt(max(np.nansum(h_terms / n_at), 0.0)))
    return all_u, all_lnl, all_logwt, logz, probs, ess, h, logzerr


class _RunningEvidence:
    """Incremental dead-point evidence/ESS accumulator for the termination
    check, O(chunk) per chunk. ``logz_dead`` is dead-only: the dlogz test
    compares the live upper bound against the dead evidence."""

    def __init__(self, n_live, shape=(), n_batch=1):
        self.n_live = n_live
        self.n_batch = max(1, int(n_batch))
        self.n_dead = 0
        self.ln_x = 0.0  # cumulative E[ln X] after n_dead removals
        self.log_s1 = np.full(shape, -np.inf)  # logsumexp of dead logwt
        self.log_s2 = np.full(shape, -np.inf)  # logsumexp of 2*dead logwt

    @staticmethod
    def _lse(a):
        m = np.max(a, axis=-1)
        m_safe = np.where(np.isfinite(m), m, 0.0)
        out = m_safe + np.log(np.sum(np.exp(a - m_safe[..., None]), axis=-1))
        return np.where(np.isfinite(m), out, -np.inf)

    def add(self, dead_lnl_chunk):
        """Fold in a chunk of dead points made of whole K-batches."""
        k = dead_lnl_chunk.shape[-1]
        idx = np.arange(self.n_dead, self.n_dead + k)
        increments = _ln_x_increments(idx, self.n_live, self.n_batch)
        ln_x = self.ln_x - np.cumsum(increments)
        ln_x_prev = np.concatenate([[self.ln_x], ln_x[:-1]])
        w = np.exp(ln_x_prev) - np.exp(ln_x)
        logwt = np.log(np.maximum(w, 1e-300)) + dead_lnl_chunk
        logwt = np.where(np.isfinite(logwt), logwt, -np.inf)
        self.log_s1 = np.logaddexp(self.log_s1, self._lse(logwt))
        self.log_s2 = np.logaddexp(self.log_s2, self._lse(2.0 * logwt))
        self.n_dead += k
        self.ln_x = float(ln_x[-1])

    def status(self, live_lnl):
        """(dead-only logz, posterior ESS incl. live points)."""
        x_final = np.exp(self.ln_x)
        logwt_live = np.log(x_final / self.n_live) + live_lnl
        logwt_live = np.where(np.isfinite(logwt_live), logwt_live, -np.inf)
        l1 = self._lse(logwt_live)
        l2 = self._lse(2.0 * logwt_live)
        s1 = np.logaddexp(self.log_s1, l1)
        s2 = np.logaddexp(self.log_s2, l2)
        with np.errstate(invalid="ignore"):
            ess = np.where(np.isfinite(s1), np.exp(2.0 * s1 - s2), 0.0)
        return self.log_s1, ess


# The configuration names the package: a checkpoint of the JAX package holds
# a JAX key where this one holds a ``torch.Generator`` state, and is refused.
_CKPT_VERSION = 2
_CKPT_PACKAGE = "isochrones_torch"


class CheckpointConfigError(ValueError):
    """A resume checkpoint was written under a different sampler
    configuration or for a different problem (data/bounds/seed hash
    mismatch). An operator's error, not a transient fit failure: callers
    that log per-folder failures re-raise it."""


def _ckpt_save(path, state):
    """Persist a checkpoint atomically (pickle to a temporary file, then
    rename), so a kill in mid-write leaves the previous checkpoint whole. The
    payload is numpy arrays, ints and the numpy bit-generator state."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def _ckpt_load(path, config):
    """Load and validate a checkpoint written by :func:`_ckpt_save`. The
    stored configuration must equal ``config``: resuming under another
    n_live/n_batch/... would corrupt the shrinkage schedule."""
    with open(path, "rb") as f:
        state = pickle.load(f)
    stored = state.get("config", {}) if isinstance(state, dict) else {}
    if stored.get("version") != _CKPT_VERSION:
        raise CheckpointConfigError(
            f"nested-sampling checkpoint {path!r} has version {stored.get('version')!r}, expected {_CKPT_VERSION}"
        )
    if stored != config:
        raise CheckpointConfigError(
            f"nested-sampling checkpoint {path!r} was written with a different "
            f"sampler configuration:\n  stored:   {stored}\n"
            f"  expected: {config}\nRefusing to resume."
        )
    return state


#: the checkpoint's arrays with a problem axis, which a single run's checkpoint
#: holds without it
_PROBLEM_ARRAYS = ("dead_u", "dead_lnl", "live_u", "live_lnl", "scale", "running_log_s1", "running_log_s2")


def _chunk_dead(n_live):
    """Dead points per chunk: each chunk boundary is one host read-back."""
    return max(int(n_live), 256)


def _thread_starts(merged, posterior_frac, n_live):
    """Activation threshold + start snapshot for one dynamic-NS thread
    round: ``(L_lo, starts_u, starts_lnl)``: the ``n_live`` merged samples
    just above the likelihood level enclosing ``1 - posterior_frac`` of the
    current posterior mass (shared by the single-problem and problem-family
    dynamic paths)."""
    all_u_m, all_lnl_m, _, _, probs_m, _, _, _ = merged
    cum = np.cumsum(probs_m)
    i_lo = int(np.searchsorted(cum, posterior_frac))
    i_lo = min(i_lo, max(len(all_lnl_m) - n_live - 1, 0))
    sl = slice(i_lo + 1, i_lo + 1 + n_live)
    return float(all_lnl_m[i_lo]), all_u_m[sl], all_lnl_m[sl]


# ------------------------------------------------------------------ device loop
# The JAX package runs a family of problems as ``jax.vmap`` of its single-run
# step. A likelihood that launches a ctypes kernel cannot be
# ``torch.vmap``-ped, so the functions below write the problem axis M out on
# every op and call the likelihood once per walk step on all problems' points;
# a single run is a family of one. One ``torch.Generator`` drives the family
# (the JAX package splits one key per problem), so a problem's draws depend on
# M and on the other problems' shapes: the two packages agree statistically,
# not draw for draw.


def _gather_rows(x, idx):
    """``x[m, idx[m]]`` for (M, n, ...) ``x`` and (M, k) ``idx``."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _live_cholesky_family(live_u, jitter=1e-12):
    """Cholesky factor of each problem's live-point covariance plus a
    relative ridge, (M, n, p) -> (M, p, p), which whitens the walk proposals.
    A problem whose factorization fails gets a NaN factor, as
    ``jnp.linalg.cholesky`` returns (``cholesky_ex`` does not synchronize)."""
    mu = live_u.mean(dim=1, keepdim=True)
    c = live_u - mu
    cov = c.transpose(1, 2) @ c / live_u.shape[1]
    d = live_u.shape[-1]
    ridge = jitter + 1e-6 * torch.clamp(torch.diagonal(cov, dim1=1, dim2=2).max(dim=-1).values, min=0.0)
    cov = cov + ridge[:, None, None] * torch.eye(d, dtype=live_u.dtype, device=live_u.device)
    L, info = torch.linalg.cholesky_ex(cov)
    return torch.where((info == 0)[:, None, None], L, torch.full_like(L, float("nan")))


def _constrained_walk_family(lnlike_fam, g, start, lnl_start, lnl_star, scale, n_groups, n_chains, n_repeat, L=None):
    """Random walk of ``n_groups * n_chains`` chains of each of M problems in
    {u : lnlike(u) > lnl_star}, ``n_repeat`` steps, proposals ``scale * L @
    normal`` folded into the cube: ``start`` (M, n_groups * n_chains, p),
    ``lnl_start`` likewise (M, ...), per-problem thresholds ``lnl_star``,
    scales ``scale`` and factors ``L`` (M, p, p). ``lnlike_fam`` maps (M, n,
    p) unit-cube points to (M, n). Per group, returns one sample picked at
    random among the group's chains that moved (else a start point), (M,
    n_groups, p), its lnL, whether it moved, and each problem's acceptance
    rate (M,)."""
    x, lnl = start, lnl_start
    M = start.shape[0]
    n_acc = torch.zeros(lnl_start.shape, dtype=torch.int32, device=start.device)
    for _ in range(n_repeat):
        with span("nested.walk_step"):
            eps = torch.randn(x.shape, generator=g, device=x.device, dtype=x.dtype)
            if L is not None:
                eps = eps @ L.transpose(1, 2)
            prop = x + eps * scale[:, None, None]
            prop = 1.0 - torch.abs(1.0 - torch.abs(prop) % 2.0)
            lnl_prop = lnlike_fam(prop)
            lnl_prop = torch.where(torch.isnan(lnl_prop), float("-inf"), lnl_prop)
            ok = lnl_prop > lnl_star[:, None]
            x = torch.where(ok[..., None], prop, x)
            lnl = torch.where(ok, lnl_prop, lnl)
            n_acc = n_acc + ok.to(torch.int32)
    moved = (n_acc > 0).reshape(M, n_groups, n_chains)
    scores = torch.rand((M, n_groups, n_chains), generator=g, device=x.device, dtype=x.dtype) + moved.to(x.dtype)
    pick = torch.argmax(scores, dim=2, keepdim=True)  # (M, n_groups, 1)
    xf = x.reshape(M, n_groups, n_chains, -1)
    x_pick = torch.gather(xf, 2, pick[..., None].expand(-1, -1, -1, xf.shape[-1]))[:, :, 0]
    lnl_pick = torch.gather(lnl.reshape(M, n_groups, n_chains), 2, pick)[..., 0]
    moved_pick = torch.gather(moved, 2, pick)[..., 0]
    accept_rate = n_acc.sum(dim=1).to(x.dtype) / (n_groups * n_chains * n_repeat)
    return x_pick, lnl_pick, moved_pick, accept_rate


def _family_step(lnlike_fam, u, lnl, g, scale, n_live, n_chains, n_repeat, K):
    """One step of a family run (:class:`_FamilySteps`): the ``K`` worst live points
    of each problem die (ascending in lnL) and constrained walks above the
    highest of them replace them. Returns ``(dead_u (M, K, p), dead_lnl (M,
    K), u, lnl, scale)``."""
    M = u.shape[0]
    neg_vals, worst = torch.topk(-lnl, K, dim=-1)  # each problem's K smallest lnL, ascending
    d_lnl = -neg_vals
    d_u = _gather_rows(u, worst)
    lnl_star = d_lnl[:, -1]

    # walks start from survivors only: positions K.. of the sorted order
    order = torch.argsort(lnl, dim=-1)
    pick = torch.randint(K, n_live, (M, K * n_chains), generator=g, device=u.device)
    starts = torch.gather(order, 1, pick)
    L = _live_cholesky_family(u)
    new_u, new_lnl, _, acc = _constrained_walk_family(
        lnlike_fam, g, _gather_rows(u, starts), _gather_rows(lnl, starts), lnl_star, scale, K, n_chains, n_repeat,
        L=L,
    )
    u = u.scatter(1, worst[..., None].expand(-1, -1, u.shape[-1]), new_u)
    lnl = lnl.scatter(1, worst, new_lnl)
    # adapt toward ~35% acceptance (whitened proposals: O(1) scales)
    scale = torch.clamp(scale * torch.exp(0.7 * (acc - 0.35)), 1e-4, 4.0)
    return d_u, d_lnl, u, lnl, scale


def _graphed(device, mesh):
    """Whether a family run replays its step as a CUDA graph: walks on a
    CUDA device and no mesh (a mesh's shards launch on other devices)."""
    return device.type == "cuda" and mesh is None


def _launch_counters():
    """The kernel wrappers of the loaded ``isochrones_torch.ops`` modules that
    count their launches (``fn.launches``)."""
    found = {}
    for name, mod in list(sys.modules.items()):
        if name.startswith("isochrones_torch.ops.") and mod is not None:
            for fn in vars(mod).values():
                if callable(fn) and isinstance(getattr(fn, "launches", None), int):
                    found[id(fn)] = fn
    return list(found.values())


def _capture(body, g):
    """``body()`` captured once as a CUDA graph on a side stream, in
    thread-local error mode, with the generator ``g`` registered so that each
    replay draws from ``g``'s state at its launch and advances ``g`` as the
    eager body would. Nothing runs during the capture, so the kernel
    wrappers' launch counters are set back after it, and each replay adds
    what the capture counted. Returns ``replay()``, which launches the graph
    on the current stream and returns ``body``'s outputs (the graph's static
    tensors). Raises where the body cannot be captured (a read-back to the
    host, a copy from pageable memory)."""
    dev = g.device
    counters = _launch_counters()
    before = [fn.launches for fn in counters]
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(g)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    try:
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = body()
            except BaseException:
                try:
                    graph.capture_end()  # void now; the body's error says why
                except Exception:  # noqa: BLE001
                    pass
                raise
            graph.capture_end()
    finally:
        added = [fn.launches - n for fn, n in zip(counters, before)]
        for fn, n in zip(counters, before):
            fn.launches = n
    torch.cuda.current_stream(dev).wait_stream(side)

    def replay():
        graph.replay()
        for fn, n in zip(counters, added):
            fn.launches += n
        return out
    return replay


class _FamilySteps:
    """The steps of one family run (:func:`_family_step` in lockstep over M
    problems), in chunks; with ``graphed`` the second and later steps replay
    one CUDA graph of the step.

    The run's first step is eager: it makes the library handles and the
    likelihood's lazily built tensors before any capture. The second
    captures the step (the likelihood and ``_constrained_walk_family`` as
    the module holds them then) over static buffers of the live set, its lnL
    and the scales, which the graph writes in place, and a generator of the
    graph's own; that step and every later one replay it. The live state and
    the run generator's state move into the graph at a chunk's first replay
    and out of it at the chunk's end, so no buffer escapes a chunk and the
    run's generator reads, between chunks, what the eager steps leave. A
    capture that raises touches neither: it logs one warning and leaves the
    run eager from the same state. (A generator registered with a capture
    that fails stays in capture mode, since ``capture_end`` raises before it
    closes the generator's capture, and then refuses every eager draw; the
    graph's own generator is dropped with the failed graph.) The graph and
    its memory go with the object."""

    def __init__(self, lnlike_fam, g, n_live, n_chains, n_repeat, n_batch, graphed=False):
        self.step = lambda u, lnl, scale, gen: _family_step(lnlike_fam, u, lnl, gen, scale, n_live, n_chains,
                                                            n_repeat, n_batch)
        self.g, self.K, self.graphed = g, n_batch, graphed
        self.steps = 0
        self.replay = self.state = self.gen = None

    def chunk(self, u, lnl, scale, n_iter):
        """``n_iter`` steps from the live sets ``u`` (M, n_live, p), their
        ``lnl`` (M, n_live) and the per-problem walk scales ``scale`` (M,).
        Dead points come out (M, n_iter * n_batch, ...), ascending in lnL
        within each batch of each problem."""
        K = self.K
        M, _, p = u.shape
        dead_u = u.new_empty((M, n_iter * K, p))
        dead_lnl = lnl.new_empty((M, n_iter * K))
        in_graph = False  # whether the live state sits in the graph's buffers
        for i in range(n_iter):
            with span("nested.step"):
                if self.graphed and self.steps and self.replay is None:
                    self.graphed = False  # one capture a run, whether it holds or not
                    gen = torch.Generator(device=self.g.device)
                    state = tuple(torch.empty_like(t) for t in (u, lnl, scale))

                    def body():
                        d_u, d_lnl, *new = self.step(*state, gen)
                        for buf, t in zip(state, new):
                            buf.copy_(t)
                        return d_u, d_lnl

                    try:
                        with span("nested.capture"):
                            self.replay = _capture(body, gen)
                        self.state, self.gen = state, gen
                    except Exception as err:  # noqa: BLE001 - any failure leaves the run eager
                        getLogger().warning(
                            "run_nested_vmapped: the nested step could not be captured as a CUDA graph (%s: %s); "
                            "the run goes on without one.", type(err).__name__, (str(err).splitlines() or [""])[0])
                if self.replay is not None:
                    if not in_graph:
                        for buf, t in zip(self.state, (u, lnl, scale)):
                            buf.copy_(t)
                        self.gen.set_state(self.g.get_state())
                        in_graph = True
                    with span("nested.replay"):
                        d_u, d_lnl = self.replay()
                else:
                    d_u, d_lnl, u, lnl, scale = self.step(u, lnl, scale, self.g)
                dead_u[:, i * K:(i + 1) * K] = d_u
                dead_lnl[:, i * K:(i + 1) * K] = d_lnl
            self.steps += 1
        if in_graph:
            u, lnl, scale = (buf.clone() for buf in self.state)
            self.g.set_state(self.gen.get_state())
        return dead_u, dead_lnl, u, lnl, scale


def _family_terminated(running, live_lnl_np, dlogz):
    """Per problem, whether the live points' share of the evidence bound is
    below ``dlogz``, and the posterior ESS including the live points."""
    logz_dead, ess_now = running.status(live_lnl_np)
    logz_remain = np.max(live_lnl_np, axis=1) + running.ln_x
    with np.errstate(invalid="ignore"):
        frac = np.exp(logz_remain - np.logaddexp(logz_dead, logz_remain))
    return frac < dlogz, ess_now, logz_dead


class _Family(NamedTuple):
    """What :func:`_run_family` hands its front."""

    problem: Callable  # s -> (all_u, all_lnl, all_logwt, logz, probs, ess, h, logzerr) of problem s
    done: np.ndarray  # (M,) the stop rule's verdict at the end of the base run
    n_dead: int  # dead points of each problem, base run and threads
    dynamic_rounds: int


def _run_family(lnlike_fam, init, g, rng, *, kind, ckpt_extra, n_params, n_live, n_batch, n_chains, n_repeat,
                hard_cap, dlogz, min_ess, dtype, stop=None, dynamic=False, posterior_frac=0.025, max_dynamic_rounds=8,
                checkpoint=None, resume=False, config_tag=None, chunk=None, graphed=False):
    """The engine of every nested run: M problems in lockstep, a single run
    being a family of one. The fronts (:func:`run_nested`, single or ``n_runs
    > 1``, and :func:`run_nested_vmapped`) bring their likelihood, initial
    points and stop rule, and turn each problem's assembly into their result.

    lnlike_fam : (M, B, n_params) unit-cube points -> (M, B) ln-likelihoods.
    init : ``() -> (live_u (M, n_live, n_params), live_lnl (M, n_live))``,
        tensors on the generator's device; called only when no checkpoint is
        restored.
    g, rng : the ``torch.Generator`` of every device draw, and the numpy
        Generator of the front's host draws, whose state the checkpoint keeps.
    stop : ``stop(running, live_lnl_np) -> (M,)`` bools, whether each
        problem's base run is done after a chunk. By default the live points'
        share of the evidence bound is below ``dlogz`` and, unless
        ``dynamic`` (whose threads see to it), the posterior ESS is at least
        ``min_ess``. The chunks go on until every problem is done; those done
        keep shrinking with the others.
    kind, ckpt_extra : the checkpoint's kind and its configuration's own
        entries. A ``"single"`` checkpoint holds its arrays without the
        problem axis.
    chunk : a chunk of steps with :meth:`_FamilySteps.chunk`'s signature and
        contract, in place of the walk's.
    graphed : replay the walk's step as a CUDA graph (:class:`_FamilySteps`).

    With ``dynamic``, after the base runs and while any problem's ESS is
    below ``min_ess``, rounds of posterior-focused threads, one per problem,
    merged through :func:`_merge_segments`; each problem's assembly is then
    the merged one, even when no thread ran.
    """
    dev = g.device
    ckpt_cfg = state = None
    if checkpoint is not None:
        ckpt_cfg = dict(
            version=_CKPT_VERSION, package=_CKPT_PACKAGE, kind=kind, n_params=int(n_params), n_live=int(n_live),
            n_batch=int(n_batch), n_chains=int(n_chains), n_repeat=int(n_repeat), chunk=int(_chunk_dead(n_live)),
            dtype=str(dtype), device=dev.type, config_tag=None if config_tag is None else str(config_tag),
            **ckpt_extra,
        )
        if resume and os.path.exists(checkpoint):
            state = _ckpt_load(checkpoint, ckpt_cfg)
    single = kind == "single"
    if chunk is None:
        chunk = _FamilySteps(lnlike_fam, g, n_live, n_chains, n_repeat, n_batch, graphed=graphed).chunk

    if state is None:
        live_u, live_lnl = init()
        live_lnl_np = live_lnl.cpu().numpy()
        M = live_u.shape[0]
        scales = torch.full((M,), 0.5, dtype=dtype, device=dev)  # whitened units
        dead_u_chunks = [np.zeros((M, 0, n_params), dtype=live_lnl_np.dtype)]
        dead_lnl_chunks = [np.zeros((M, 0), dtype=live_lnl_np.dtype)]
        running = _RunningEvidence(n_live, shape=(M,), n_batch=n_batch)
        n_dead = 0
    else:
        # the loop-carried state at a chunk or round boundary
        arrays = {k: np.asarray(state[k])[None] if single else state[k] for k in _PROBLEM_ARRAYS}
        live_u = torch.as_tensor(arrays["live_u"], dtype=dtype, device=dev)
        live_lnl = torch.as_tensor(arrays["live_lnl"], dtype=dtype, device=dev)
        live_lnl_np = arrays["live_lnl"]
        M = live_u.shape[0]
        scales = torch.as_tensor(arrays["scale"], dtype=dtype, device=dev)
        dead_u_chunks, dead_lnl_chunks = [arrays["dead_u"]], [arrays["dead_lnl"]]
        running = _RunningEvidence(n_live, shape=(M,), n_batch=n_batch)
        running.n_dead = int(state["running_n_dead"])
        running.ln_x = float(state["running_ln_x"])
        running.log_s1, running.log_s2 = arrays["running_log_s1"], arrays["running_log_s2"]
        g.set_state(torch.from_numpy(state["generator_state"].copy()))
        rng.bit_generator.state = state["rng_state"]
        n_dead = int(state["n_dead_total"])

    chunk_steps = max(_chunk_dead(n_live) // n_batch, 8)
    segments = None  # each problem's base run and threads, from the dynamic phase on
    dynamic_rounds = 0

    def dlogz_met(running, live_lnl_np):
        return _family_terminated(running, live_lnl_np, dlogz)[0]

    if stop is None:
        def stop(running, live_lnl_np):
            met, ess_now, _ = _family_terminated(running, live_lnl_np, dlogz)
            return met if dynamic else met & (ess_now >= min_ess)

    def save(live_u, live_lnl_np):
        # the base run's dead and live points, and everything the steps and
        # the host draws carry on from
        if checkpoint is None:
            return
        arrays = dict(
            dead_u=np.concatenate(dead_u_chunks, axis=1), dead_lnl=np.concatenate(dead_lnl_chunks, axis=1),
            live_u=live_u.cpu().numpy(), live_lnl=live_lnl_np, scale=scales.cpu().numpy(),
            running_log_s1=running.log_s1, running_log_s2=running.log_s2,
        )
        threads = None if segments is None else [segs[1:] for segs in segments]
        if single:
            arrays = {k: v.reshape(v.shape[1:]) for k, v in arrays.items()}
            threads = None if threads is None else threads[0]
        _ckpt_save(checkpoint, dict(
            config=ckpt_cfg, phase="base" if segments is None else "dynamic", **arrays,
            generator_state=g.get_state().numpy().copy(), n_dead_total=n_dead,
            running_n_dead=running.n_dead, running_ln_x=running.ln_x, rng_state=rng.bit_generator.state,
            thread_segments=threads, dynamic_rounds=dynamic_rounds,
        ))

    def run_chunks(u, lnl, lnl_np, running, dead_u, dead_lnl, rule, done, save=None):
        """Chunks of steps from the live sets ``u``, ``lnl`` until ``rule``
        holds for every problem or the dead points reach the cap. Each chunk
        ends in its one read-back, and its dead points go to ``dead_u``,
        ``dead_lnl`` and ``running``. Returns the live sets, their lnL on the
        host and the last verdict."""
        nonlocal scales, n_dead
        while not done.all() and n_dead < hard_cap:
            n_steps = min(chunk_steps, max((hard_cap - n_dead) // n_batch, 1))
            with span("nested.chunk"):
                du, dl, u, lnl, scales = chunk(u, lnl, scales, n_steps)
            with span("nested.readback"):
                dead_u.append(du.cpu().numpy())  # (M, n_steps * K, n_params)
                dead_lnl.append(dl.cpu().numpy())
                lnl_np = lnl.cpu().numpy()
            n_dead += n_steps * n_batch
            with span("nested.evidence"):
                running.add(dead_lnl[-1])
                done = rule(running, lnl_np)
            if save is not None:
                save(u, lnl_np)
        return u, lnl, lnl_np, done

    done = stop(running, live_lnl_np) if running.n_dead else np.zeros(M, dtype=bool)
    if state is None or state["phase"] == "base":
        live_u, live_lnl, live_lnl_np, done = run_chunks(live_u, live_lnl, live_lnl_np, running, dead_u_chunks,
                                                         dead_lnl_chunks, stop, done, save=save)
    dead_u = np.concatenate(dead_u_chunks, axis=1)
    dead_lnl = np.concatenate(dead_lnl_chunks, axis=1)
    live_u_np = live_u.cpu().numpy()

    # ---- dynamic posterior threads, the whole family in lockstep
    merged = None
    if dynamic:
        segments = [[dict(
            dead_lnl=dead_lnl[s], live_lnl=live_lnl_np[s], n_live=n_live, n_batch=n_batch, L0=-np.inf,
            all_u=np.concatenate([dead_u[s], live_u_np[s][np.argsort(live_lnl_np[s])]], axis=0),
        )] for s in range(M)]
        if state is not None and state.get("thread_segments"):
            # completed rounds restore verbatim; an interrupted round replays
            # from its start, where the generator's state was saved
            threads = [state["thread_segments"]] if single else state["thread_segments"]
            for segs, done_threads in zip(segments, threads):
                segs.extend(done_threads)
            dynamic_rounds = int(state["dynamic_rounds"])
        merged = [_merge_segments(segs) for segs in segments]

        while n_dead < hard_cap and dynamic_rounds < max_dynamic_rounds:
            if all(mg[5] >= min_ess for mg in merged):
                break
            starts = np.empty((M, n_live, n_params))
            starts_lnl = np.empty((M, n_live))
            L_los = np.empty(M)
            for s in range(M):
                L_los[s], starts[s], starts_lnl[s] = _thread_starts(merged[s], posterior_frac, n_live)

            # decorrelate the copied starts by a whitened constrained walk, so
            # that thread deaths are fresh draws. A chain that never accepts
            # stays a copy of an existing sample (counted twice by the merge):
            # its problem retries at a halved scale (at most 1 in whitened
            # units)
            t_live_u = torch.as_tensor(starts, dtype=dtype, device=dev)
            t_live_lnl = torch.as_tensor(starts_lnl, dtype=dtype, device=dev)
            L_los_t = torch.as_tensor(L_los, dtype=dtype, device=dev)
            moved_any = np.zeros((M, n_live), dtype=bool)
            w_scales = np.minimum(scales.cpu().numpy(), 1.0)
            for _ in range(3):
                chol = _live_cholesky_family(t_live_u)
                t_live_u, t_live_lnl, mv, _ = _constrained_walk_family(
                    lnlike_fam, g, t_live_u, t_live_lnl, L_los_t, torch.as_tensor(w_scales, dtype=dtype, device=dev),
                    n_live, 1, 4 * n_repeat, L=chol,
                )
                moved_any |= mv.cpu().numpy()
                if moved_any.all():
                    break
                w_scales = np.where(moved_any.all(axis=1), w_scales, w_scales * 0.5)
            if not moved_any.all():
                getLogger().warning(
                    "dynamic nested sampling, round %d: %d of %d thread starts never moved in the decorrelation "
                    "walk (duplicated samples slightly overweight the merged posterior there).",
                    dynamic_rounds, int((~moved_any).sum()), moved_any.size,
                )

            # the threads end on their own dlogz (in thread-relative prior
            # mass)
            t_dead_u, t_dead_lnl = [], []
            t_live_u, t_live_lnl, t_live_lnl_np, _ = run_chunks(
                t_live_u, t_live_lnl, None, _RunningEvidence(n_live, shape=(M,), n_batch=n_batch), t_dead_u,
                t_dead_lnl, dlogz_met, np.zeros(M, dtype=bool),
            )
            t_dead_u = np.concatenate(t_dead_u, axis=1)
            t_dead_lnl = np.concatenate(t_dead_lnl, axis=1)
            t_live_u_np = t_live_u.cpu().numpy()
            for s in range(M):
                t_order = np.argsort(t_live_lnl_np[s])
                segments[s].append(dict(
                    dead_lnl=t_dead_lnl[s], live_lnl=t_live_lnl_np[s], n_live=n_live, n_batch=n_batch, L0=L_los[s],
                    all_u=np.concatenate([t_dead_u[s], t_live_u_np[s][t_order]], axis=0),
                ))
            merged = [_merge_segments(segs) for segs in segments]
            dynamic_rounds += 1
            save(live_u, live_lnl_np)

    def problem(s):
        # a static run's assembly is built at the call, where the front can
        # time it
        if merged is not None:
            return merged[s]
        return _assemble(dead_u[s], dead_lnl[s], live_u_np[s], live_lnl_np[s], n_live, n_batch)

    return _Family(problem, done, n_dead, dynamic_rounds)


def run_nested(
    lnpost_u: Callable,
    prior_transform: Callable,
    n_params: int,
    generator: torch.Generator = None,
    n_live: int = 500,
    max_iter: int = None,
    n_chains: int = 8,
    n_repeat: int = 24,
    n_equal: int = 4000,
    dlogz: float = 0.01,
    n_batch: int = 1,
    rng=None,
    min_ess: float = 100.0,
    on_low_ess: str = "extend",
    core: Callable = None,
    n_runs: int = 1,
    mesh=None,
    dynamic: bool = False,
    posterior_frac: float = 0.025,
    max_dynamic_rounds: int = 8,
    checkpoint: str = None,
    resume: bool = False,
    config_tag: str = None,
    dtype: torch.dtype = torch.float64,
    device=None,
) -> NestedResult:
    """Nested-sampling fit (reference samplers/nested.py:514-899).

    lnpost_u : batched fn (n, n_params) tensor -> (n,) over PARAMETER space
    prior_transform : (..., n_params) unit-cube tensor -> parameter space
    generator : ``torch.Generator`` on the device the walks run on; every
        device draw uses it. ``None``: one seeded from ``rng`` on ``device``
        (the CUDA card unless ``device`` says otherwise).
    rng : numpy seed or Generator for the host draws (initial live points,
        equal-weight resampling).
    dlogz : stop when the live points' share of the evidence bound drops
        below this; ``min_ess`` additionally requires that posterior ESS.
    n_batch : live points replaced per step; the weights use the exact
        batched-K shrinkage schedule, so the evidence is unbiased at any K
        (clamped to n_live // 4).
    max_iter : hard cap on dead points (default 1000 * n_live).
    on_low_ess : "extend"/"warn" warn and flag ``truncated``; "raise" raises.
    core : the replacement kernel, in place of the constrained random walk:
        ``core(lnlike_u, u, lnl, g, scale, n_live, n_iter, n_chains,
        n_repeat, n_batch=n_batch)`` runs ``n_iter`` steps from the live set
        ``u`` (n_live, n_params), its ln-likelihoods ``lnl`` (n_live,) and the
        adapted scale ``scale`` (a 0-d tensor), each step removing the
        ``n_batch`` worst live points and replacing them with draws above the
        highest of them. ``lnlike_u`` maps (B, n_params) unit-cube points to
        (B,) ln-likelihoods and ``g`` is the generator. It returns
        ``(dead_u (n_iter * n_batch, n_params), dead_lnl, u, lnl, scale)``,
        the dead points of each batch in ascending lnL (the shrinkage
        schedule depends on that order). The base run and the dynamic
        threads both run it
        (:func:`~isochrones_torch.samplers.polychord.run_polychord`'s slice
        sampler). Not with ``n_runs > 1``.
    dynamic : dynamic nested sampling (Higson et al. 2019). The base run stops
        on the evidence criterion alone; while the posterior ESS is below
        ``min_ess``, posterior-focused threads run: fresh ``n_live``-point
        runs activated at the likelihood level that encloses
        ``1 - posterior_frac`` of the posterior mass, merged with the base run
        through :func:`_merge_segments` (which then weighs the result, threads
        or not). ``dynamic=False`` is the static auto-extend behaviour.
    posterior_frac : lower cumulative-posterior-mass cut of each thread's
        activation threshold.
    max_dynamic_rounds : cap on thread rounds.
    checkpoint : path; the full sampler state is written there after every
        chunk and every thread round, atomically.
    resume : with ``checkpoint``, restore from an existing file and continue;
        the completed run is bitwise the run that never stopped (the state
        holds the generator's state, the adapted walk scale, the running
        evidence and the host RNG state). A missing file starts fresh; a
        checkpoint of another configuration, or of the JAX package, raises
        :class:`CheckpointConfigError`.
    config_tag : opaque string folded into the checkpoint's configuration;
        callers hash the problem (data, bounds, seed) into it.
    dtype : dtype of the unit-cube points handed to the likelihood.

    n_runs : > 1 runs this many independent runs of the same problem in
        lockstep: one likelihood call of ``n_runs * n_batch * n_chains``
        points per walk step. The loop stops when every run has met
        ``dlogz`` and the pooled Z-weighted ESS reaches ``min_ess``. The
        evidence is ln(mean Z_r), ``logzerr`` the larger of the runs'
        empirical scatter and the averaged shrinkage estimate, the posterior
        Z-weighted draws from every run, ``logz_runs`` the per-run evidences.
        It does not go with ``dynamic`` (a ``ValueError``, as in the JAX
        package).
    mesh : an :class:`~isochrones_torch.parallel.Mesh` whose first device is
        the generator's: a single run shards each likelihood call's batch
        (the walk points, the initial live points), ``n_runs > 1`` the run
        axis. ``lnpost_u`` is called on each shard's device.
    """
    R = int(n_runs)
    if R > 1:
        if core is not None:
            raise ValueError("core= runs one problem at a time; combine it with n_runs=1")
        if dynamic:
            raise ValueError(
                "dynamic=True supports n_runs=1 — independent runs already "
                "multiply posterior coverage; combine one or the other"
            )
    hard_cap = max_iter if max_iter is not None else 1000 * n_live
    n_batch = max(1, min(int(n_batch), n_live // 4))
    rng = np.random.default_rng(rng)
    if generator is None:
        generator = torch.Generator(device=device if device is not None else "cuda")
        generator.manual_seed(int(rng.integers(2 ** 31)))
    g = generator
    dev = g.device

    def lnlike_u(u):
        return lnpost_u(prior_transform(u))

    def lnlike_fam(u):  # (R, B, p) -> (R, B) through one call of R * B points
        return lnlike_u(u.reshape(-1, n_params)).reshape(u.shape[0], -1)

    if mesh is not None:
        from ..parallel import check_mesh, mesh_wrap_fn

        # a single run's mesh splits each call's batch of points, n_runs > 1's
        # the run axis
        if R == 1:
            lnlike_u = mesh_wrap_fn(lnlike_u, check_mesh(mesh, dev))
        else:
            lnlike_fam = mesh_wrap_fn(lnlike_fam, check_mesh(mesh, dev))

    def lnlike_host(u_np):
        out = lnlike_fam(torch.as_tensor(u_np, dtype=dtype, device=dev)).cpu().numpy()
        return np.where(np.isnan(out), -np.inf, out)

    def init_single():
        # uniform draws; -inf starts are resampled in full (n_live, n_params)
        # batches
        u0 = np.array(rng.random((n_live, n_params)))
        lnl0 = lnlike_host(u0[None])[0]
        bad = ~np.isfinite(lnl0)
        tries = 0
        while bad.any() and tries < 200:
            u_new = rng.random((n_live, n_params))
            l_new = lnlike_host(u_new[None])[0]
            good_new = np.isfinite(l_new)
            n_take = min(int(bad.sum()), int(good_new.sum()))
            if n_take:
                bad_idx = np.where(bad)[0][:n_take]
                good_idx = np.where(good_new)[0][:n_take]
                u0[bad_idx] = u_new[good_idx]
                lnl0[bad_idx] = l_new[good_idx]
            bad = ~np.isfinite(lnl0)
            tries += 1
        return torch.as_tensor(u0[None], dtype=dtype, device=dev), torch.as_tensor(lnl0[None], dtype=dtype, device=dev)

    def init_runs():
        # per run; -inf starts are resampled in full (R, n_live, n_params)
        # batches
        u0 = rng.random((R, n_live, n_params))
        lnl0 = lnlike_host(u0)
        for _ in range(200):
            bad = ~np.isfinite(lnl0)
            if not bad.any():
                break
            u_new = rng.random((R, n_live, n_params))
            l_new = lnlike_host(u_new)
            take = bad & np.isfinite(l_new)
            u0 = np.where(take[..., None], u_new, u0)
            lnl0 = np.where(take, l_new, lnl0)
        return torch.as_tensor(u0, dtype=dtype, device=dev), torch.as_tensor(lnl0, dtype=dtype, device=dev)

    def pooled_stop(running, live_lnl_np):
        # every run has met dlogz, and the pooled ESS of the Z-weighted
        # mixture, as the final report computes it, reaches min_ess
        met, ess_now, logz_dead = _family_terminated(running, live_lnl_np, dlogz)
        if np.any(np.isfinite(logz_dead)):
            zw = np.exp(logz_dead - np.logaddexp.reduce(logz_dead))
        else:
            zw = np.full(R, 1.0 / R)
        pooled_ess = 1.0 / np.sum(zw ** 2 / np.maximum(ess_now, 1e-12))
        return np.full(R, met.all() and pooled_ess >= min_ess)

    chunk = None
    ckpt_extra = dict(n_runs=R) if R > 1 else {}
    if core is not None:
        ckpt_extra = dict(core=f"{core.__module__}.{core.__qualname__}")

        def chunk(u, lnl, scale, n_iter):
            # core= steps one problem: the family of one loses its axis and
            # gets it back
            out = core(lnlike_u, u[0], lnl[0], g, scale[0], n_live, n_iter, n_chains, n_repeat, n_batch=n_batch)
            return tuple(t[None] for t in out)

    run = _run_family(
        lnlike_fam, init_single if R == 1 else init_runs, g, rng, kind="single" if R == 1 else "multi",
        n_params=n_params, n_live=n_live, n_batch=n_batch, n_chains=n_chains, n_repeat=n_repeat, hard_cap=hard_cap,
        dlogz=dlogz, min_ess=min_ess, dtype=dtype, stop=None if R == 1 else pooled_stop, dynamic=dynamic,
        posterior_frac=posterior_frac, max_dynamic_rounds=max_dynamic_rounds, checkpoint=checkpoint, resume=resume,
        config_tag=config_tag, ckpt_extra=ckpt_extra, chunk=chunk,
    )

    if R == 1:
        all_u, all_lnl, all_logwt, logz, probs, ess, h, logzerr = run.problem(0)
        truncated = ess < min_ess
        if truncated:
            if dynamic and run.dynamic_rounds >= max_dynamic_rounds:
                hint = (f"the dynamic thread budget ran out (max_dynamic_rounds={max_dynamic_rounds}); "
                        f"raise max_dynamic_rounds or n_live.")
            else:
                hint = "Raise max_iter (or leave it None) or n_live."
            msg = (
                f"Nested-sampling posterior ESS is only {ess:.0f} < min_ess={min_ess:.0f} "
                f"after exhausting the iteration budget (max_iter={max_iter}); "
                f"quantiles are unreliable. {hint}"
            )
            if on_low_ess == "raise":
                raise RuntimeError(msg)
            getLogger().warning(msg)

        # equal-weight posterior resampling (the post_equal_weights.dat analog)
        params_all = prior_transform(torch.as_tensor(all_u, dtype=dtype, device=dev)).cpu().numpy()
        idx = rng.choice(len(probs), size=n_equal, replace=True, p=probs)
        return NestedResult(
            samples=params_all,
            logl=all_lnl,
            logwt=all_logwt,
            logz=float(logz),
            logzerr=logzerr,
            h=h,
            n_iter=run.n_dead,
            posterior=params_all[idx],
            logl_posterior=all_lnl[idx],
            ess=ess,
            truncated=truncated,
            dynamic_rounds=run.dynamic_rounds,
        )

    # ---- n_runs > 1 (the JAX package's ``_run_nested_multi``,
    # isochrones_tpu/samplers/nested.py:902-1124): each run's assembly, then
    # the Z-weighted combination
    logz_runs = np.empty(R)
    h_runs = np.empty(R)
    ess_runs = np.empty(R)
    run_samples, run_logl, run_logwt, run_probs = [], [], [], []
    for r in range(R):
        all_u, all_lnl, all_logwt, logz_runs[r], probs, ess_runs[r], h_runs[r], _ = run.problem(r)
        run_samples.append(prior_transform(torch.as_tensor(all_u, dtype=dtype, device=dev)).cpu().numpy())
        run_logl.append(all_lnl)
        run_logwt.append(all_logwt - np.log(R))  # so that the sum over all runs is mean Z_r
        run_probs.append(probs)

    # ln(mean Z_r); the error is the larger of the runs' empirical scatter and
    # the averaged shrinkage estimate
    logz = float(np.logaddexp.reduce(logz_runs) - np.log(R))
    err_emp = float(np.std(logz_runs, ddof=1) / np.sqrt(R))
    err_shrink = float(np.sqrt(np.mean(np.maximum(h_runs, 0.0)) * _logzerr_scale(n_live, n_batch) / R))
    logzerr = max(err_emp, err_shrink)

    # Z-weighted equal-weight posterior: runs picked in proportion to Z_r
    z_w = np.exp(logz_runs - np.logaddexp.reduce(logz_runs))
    n_eq_run = rng.multinomial(n_equal, z_w)
    post_chunks, post_lnl_chunks = [], []
    for r in range(R):
        if n_eq_run[r] == 0:
            continue
        idx = rng.choice(len(run_probs[r]), size=n_eq_run[r], replace=True, p=run_probs[r])
        post_chunks.append(run_samples[r][idx])
        post_lnl_chunks.append(run_logl[r][idx])

    # pooled ESS of the Z-weighted mixture
    ess = float(1.0 / np.sum(z_w ** 2 / np.maximum(ess_runs, 1e-12)))
    truncated = ess < min_ess
    if truncated:
        msg = (
            f"Multi-run nested sampling: combined posterior ESS {ess:.0f} < "
            f"min_ess={min_ess:.0f} after the iteration budget "
            f"(max_iter={max_iter}); quantiles are unreliable."
        )
        if on_low_ess == "raise":
            raise RuntimeError(msg)
        getLogger().warning(msg)

    return NestedResult(
        samples=np.concatenate(run_samples, axis=0),
        logl=np.concatenate(run_logl),
        logwt=np.concatenate(run_logwt),
        logz=logz,
        logzerr=logzerr,
        h=float(np.mean(h_runs)),
        n_iter=run.n_dead * R,
        posterior=np.concatenate(post_chunks, axis=0),
        logl_posterior=np.concatenate(post_lnl_chunks),
        ess=ess,
        truncated=truncated,
        logz_runs=logz_runs,
    )


@np.errstate(divide="ignore", invalid="ignore")  # a problem without support has -inf evidences
@spanned("nested.run")
def run_nested_vmapped(
    lnlike_u: Callable,
    data,
    live_u,
    live_lnl,
    *,
    n_live: int,
    n_batch: int = 8,
    n_chains: int = 8,
    n_repeat: int = 24,
    n_equal: int = 2000,
    dlogz: float = 0.01,
    min_ess: float = 100.0,
    max_iter: int = None,
    seed=None,
    rng=None,
    mesh=None,
    label: str = "problem",
    dynamic: bool = False,
    posterior_frac: float = 0.025,
    max_dynamic_rounds: int = 8,
    checkpoint: str = None,
    resume: bool = False,
    config_tag: str = None,
    device=None,
    dtype: torch.dtype = None,
):
    """Nested sampling over a family of M independent problems in lockstep
    (counterpart of ``isochrones_tpu/samplers/nested.py:1126-1505``): every
    problem keeps its own live set and walk scale, termination is per problem
    (``dlogz``, and ``min_ess`` unless ``dynamic``), and the chunk loop stops
    when every problem is done; problems already done keep shrinking with the
    others. It is the sampler of ``BatchStarFitter.fit_multinest``.

    lnlike_u : ``lnlike_u(data, u)`` maps unit-cube points (M, B, n_params) to
        ln-likelihoods (M, B) for the whole family in one call. This takes the
        place of the JAX package's ``make_lnlike_u(data_m)``, a per-problem
        closure that ``jax.vmap`` maps over ``data``: a ctypes kernel call
        cannot be vmapped in torch, so the family function sees all problems.
        With ``mesh`` it may be a list of one such function per shard (a
        shard's own data), as :func:`~isochrones_torch.parallel.mesh_wrap_fn`
        takes.
    data : handed to ``lnlike_u`` unchanged (one row per problem).
    live_u, live_lnl : (M, n_live, n_params) / (M, n_live) initial live points
        and their ln-likelihoods (tensors or arrays): draw from the prior and
        resample -inf rows first (as ``BatchStarFitter.fit_multinest`` does).
    rng : numpy Generator driving the seed of the walks' ``torch.Generator``
        and the equal-weight resampling; it takes precedence over ``seed``,
        which otherwise seeds the generator directly.
    dynamic : dynamic nested sampling for the whole family: after the base
        runs, while any problem's ESS is below ``min_ess``, a round of
        posterior-focused threads (one per problem, per-problem activation
        thresholds, a whitened decorrelation walk retried at a halved scale
        for problems whose starts did not move, merged through
        :func:`_merge_segments`).
    checkpoint, resume, config_tag : as :func:`run_nested`; a resumed run is
        bitwise the run that never stopped.
    device, dtype : of the walks; by default those of ``live_u`` when it is a
        tensor, else the CUDA card and float64.

    mesh : an :class:`~isochrones_torch.parallel.Mesh` whose first device is
        the walks' device: each call's problem axis (of ``data`` and the
        points) is split over the shards, and ``lnlike_u`` sees one shard's
        rows on its shard's device.

    On a CUDA device without a mesh, the second and later steps (of the base
    runs and of the threads) replay one CUDA graph of the step, captured at
    the second step with the ``lnlike_u`` of this call and freed when it
    returns: bitwise the eager steps. ``lnlike_u`` must then queue its work on
    the current stream without reading back to the host; one that cannot be
    captured leaves the run eager, with a warning.

    One ``torch.Generator`` drives the family's draws, where the JAX package
    splits a key per problem: a problem's draws depend on M, so the two
    packages agree statistically, not draw for draw.

    Returns a dict of per-problem arrays ``logz``, ``logzerr``, ``ess``,
    ``converged``, ``samples_u`` (M, n_equal, n_params) equal-weight draws in
    the unit cube (NaN for a problem with no posterior support), ``lnl`` (M,
    n_equal), and the scalars ``n_dead`` and ``dynamic_rounds``.
    """
    M, n_live_in, n_params = live_u.shape
    if n_live_in != int(n_live):
        raise ValueError(f"live_u has {n_live_in} live points, expected n_live={n_live}")
    if device is None:
        device = live_u.device if isinstance(live_u, torch.Tensor) else "cuda"
    if dtype is None:
        dtype = live_u.dtype if isinstance(live_u, torch.Tensor) else torch.float64
    n_live = int(n_live)
    n_batch = max(1, min(int(n_batch), n_live // 4))
    hard_cap = max_iter if max_iter is not None else 1000 * n_live
    rng_given = rng is not None
    rng = np.random.default_rng(seed) if rng is None else rng
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(rng.integers(2 ** 31)) if (rng_given or seed is None) else int(seed))
    dev = g.device

    family = lnlike_u
    if mesh is not None:
        from ..parallel import check_mesh, mesh_wrap_fn

        family = mesh_wrap_fn(lnlike_u, check_mesh(mesh, dev))

    def fam(u):
        return family(data, u)

    def init():
        return torch.as_tensor(live_u, dtype=dtype, device=dev), torch.as_tensor(live_lnl, dtype=dtype, device=dev)

    # the base runs' and the threads' steps, replayed as one CUDA graph where
    # that engages, else eager
    run = _run_family(
        fam, init, g, rng, kind="vmapped", n_params=n_params, n_live=n_live, n_batch=n_batch, n_chains=n_chains,
        n_repeat=n_repeat, hard_cap=hard_cap, dlogz=dlogz, min_ess=min_ess, dtype=dtype, dynamic=dynamic,
        posterior_frac=posterior_frac, max_dynamic_rounds=max_dynamic_rounds, checkpoint=checkpoint, resume=resume,
        config_tag=config_tag, ckpt_extra=dict(n_problems=int(M)), graphed=_graphed(dev, mesh),
    )

    # ---- per-problem evidence and equal-weight posterior
    logz = np.empty(M)
    logzerr = np.empty(M)
    ess = np.empty(M)
    samples_u = np.empty((M, n_equal, n_params))
    lnl_eq = np.empty((M, n_equal))
    with span("nested.weights"):
        for s in range(M):
            all_u, all_lnl, _, logz[s], probs, ess[s], _, logzerr[s] = run.problem(s)
            if not np.isfinite(logz[s]) or probs.sum() <= 0:
                # no posterior support anywhere: NaN draws for this problem,
                # the family goes on
                getLogger().warning(
                    "run_nested_vmapped: %s %d has no posterior support (logz=%s); returning NaN samples for it.",
                    label, s, logz[s],
                )
                samples_u[s] = np.nan
                lnl_eq[s] = -np.inf
                continue
            idx = rng.choice(len(probs), size=n_equal, replace=True, p=probs)
            samples_u[s] = all_u[idx]
            lnl_eq[s] = all_lnl[idx]

    converged = run.done & (ess >= min_ess) if dynamic else run.done
    if not converged.all():
        hint = "raise max_dynamic_rounds or n_live" if dynamic else "raise max_iter or n_live"
        getLogger().warning(
            "run_nested_vmapped: %d/%d %ss hit the iteration budget before dlogz+ESS termination; their "
            "quantiles/evidences may be unreliable (%s).",
            int((~converged).sum()), M, label, hint,
        )

    return dict(
        logz=logz, logzerr=logzerr, ess=ess, n_dead=run.n_dead, converged=converged, samples_u=samples_u,
        lnl=lnl_eq, dynamic_rounds=run.dynamic_rounds,
    )
