"""Nested sampling on one device: the single-run path, static or dynamic,
with checkpoint and resume.

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

Not ported yet (ROADMAP queue 1): independent runs (``n_runs > 1``) and the
device mesh.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..logger import getLogger

__all__ = ["CheckpointConfigError", "NestedResult", "run_nested"]


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


def _live_cholesky(live_u, jitter=1e-12):
    """Cholesky factor of the live-point covariance plus a relative ridge,
    which whitens the walk proposals. A failed factorization is NaN, as
    ``jnp.linalg.cholesky`` returns (``cholesky_ex`` does not synchronize)."""
    mu = live_u.mean(dim=0)
    c = live_u - mu
    cov = (c.T @ c) / live_u.shape[0]
    d = live_u.shape[-1]
    ridge = jitter + 1e-6 * torch.clamp(torch.diagonal(cov).max(), min=0.0)
    cov = cov + ridge * torch.eye(d, dtype=live_u.dtype, device=live_u.device)
    L, info = torch.linalg.cholesky_ex(cov)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def _constrained_walk(lnlike_u, g, start, lnl_start, lnl_star, scale, n_groups, n_chains, n_repeat, L=None):
    """Random walk of ``n_groups * n_chains`` chains in {u : lnlike(u) >
    lnl_star}, ``n_repeat`` steps, proposals ``scale * L @ normal`` folded
    into the cube. Per group, returns one sample picked at random among the
    group's chains that moved (else a start point), its lnL, whether it
    moved, and the overall acceptance rate (a device scalar)."""
    x, lnl = start, lnl_start
    n_acc = torch.zeros(start.shape[0], dtype=torch.int32, device=start.device)
    for _ in range(n_repeat):
        eps = torch.randn(x.shape, generator=g, device=x.device, dtype=x.dtype)
        if L is not None:
            eps = eps @ L.T
        prop = x + eps * scale
        # triangle-wave fold maps all of R into [0, 1]
        prop = 1.0 - torch.abs(1.0 - torch.abs(prop) % 2.0)
        lnl_prop = lnlike_u(prop)
        lnl_prop = torch.where(torch.isnan(lnl_prop), float("-inf"), lnl_prop)
        ok = lnl_prop > lnl_star
        x = torch.where(ok[:, None], prop, x)
        lnl = torch.where(ok, lnl_prop, lnl)
        n_acc = n_acc + ok.to(torch.int32)
    moved = (n_acc > 0).reshape(n_groups, n_chains)
    scores = torch.rand((n_groups, n_chains), generator=g, device=x.device, dtype=x.dtype) + moved.to(x.dtype)
    pick = torch.argmax(scores, dim=1)
    rows = torch.arange(n_groups, device=x.device)
    xf = x.reshape(n_groups, n_chains, -1)
    lnlf = lnl.reshape(n_groups, n_chains)
    accept_rate = n_acc.sum().to(x.dtype) / (n_groups * n_chains * n_repeat)
    return xf[rows, pick], lnlf[rows, pick], moved[rows, pick], accept_rate


def _nested_core(lnlike_u, u, lnl, g, scale, n_live, n_iter, n_chains, n_repeat, n_batch=1):
    """``n_iter`` steps, each removing the ``n_batch`` worst live points and
    replacing them by constrained walks above the highest removed lnL. Dead
    points come out in ascending lnL within each batch: the harmonic schedule
    (:func:`_ln_x_increments`) depends on that order."""
    K = n_batch
    dead_u, dead_lnl = [], []
    for _ in range(n_iter):
        neg_vals, worst = torch.topk(-lnl, K)  # the K smallest lnL, ascending
        d_lnl = -neg_vals
        dead_u.append(u[worst])
        dead_lnl.append(d_lnl)
        lnl_star = d_lnl[-1]

        # walks start from survivors only: positions K.. of the sorted order
        order = torch.argsort(lnl)
        pick = torch.randint(K, n_live, (K * n_chains,), generator=g, device=u.device)
        starts = order[pick]
        L = _live_cholesky(u)
        new_u, new_lnl, _, acc = _constrained_walk(
            lnlike_u, g, u[starts], lnl[starts], lnl_star, scale, K, n_chains, n_repeat, L=L
        )
        u = u.index_copy(0, worst, new_u)
        lnl = lnl.index_copy(0, worst, new_lnl)
        # adapt toward ~35% acceptance (whitened proposals: O(1) scales)
        scale = torch.clamp(scale * torch.exp(0.7 * (acc - 0.35)), 1e-4, 4.0)
    return torch.cat(dead_u), torch.cat(dead_lnl), u, lnl, scale


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
    dynamic : dynamic nested sampling (Higson et al. 2019). The base run stops
        on the evidence criterion alone; while the posterior ESS is below
        ``min_ess``, posterior-focused threads run: fresh ``n_live``-point
        runs activated at the likelihood level that encloses
        ``1 - posterior_frac`` of the posterior mass, merged with the base run
        through :func:`_merge_segments`. ``dynamic=False`` is the static
        auto-extend behaviour, unchanged.
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

    ``n_runs > 1`` and ``mesh`` are not ported yet and raise
    ``NotImplementedError``.
    """
    for name, value, off in (("n_runs", n_runs, 1), ("mesh", mesh, None)):
        if value != off:
            raise NotImplementedError(f"run_nested({name}={value!r}) is not ported yet (ROADMAP queue 1)")
    hard_cap = max_iter if max_iter is not None else 1000 * n_live
    n_batch = max(1, min(int(n_batch), n_live // 4))
    rng = np.random.default_rng(rng)
    if generator is None:
        generator = torch.Generator(device=device if device is not None else "cuda")
        generator.manual_seed(int(rng.integers(2 ** 31)))
    g = generator
    dev = g.device

    ckpt_cfg = state = None
    if checkpoint is not None:
        ckpt_cfg = dict(
            version=_CKPT_VERSION, package=_CKPT_PACKAGE, kind="single", n_params=int(n_params),
            n_live=int(n_live), n_batch=int(n_batch), n_chains=int(n_chains), n_repeat=int(n_repeat),
            chunk=int(_chunk_dead(n_live)), dtype=str(dtype), device=dev.type,
            config_tag=None if config_tag is None else str(config_tag),
        )
        if resume and os.path.exists(checkpoint):
            state = _ckpt_load(checkpoint, ckpt_cfg)

    def lnlike_u(u):
        return lnpost_u(prior_transform(u))

    def lnlike_host(u_np):
        out = lnlike_u(torch.as_tensor(u_np, dtype=dtype, device=dev)).cpu().numpy()
        return np.where(np.isnan(out), -np.inf, out)

    chunk_steps = max(_chunk_dead(n_live) // n_batch, 8)
    running = _RunningEvidence(n_live, n_batch=n_batch)
    if state is not None:
        # the loop-carried state at a chunk or round boundary
        dead_u_chunks = [state["dead_u"]]
        dead_lnl_chunks = [state["dead_lnl"]]
        live_u = torch.as_tensor(state["live_u"], dtype=dtype, device=dev)
        live_lnl = torch.as_tensor(state["live_lnl"], dtype=dtype, device=dev)
        live_lnl_np = state["live_lnl"]
        g.set_state(torch.from_numpy(state["generator_state"].copy()))
        scale = torch.as_tensor(state["scale"], dtype=dtype, device=dev)
        n_dead_total = int(state["n_dead_total"])
        running.n_dead = int(state["running_n_dead"])
        running.ln_x = float(state["running_ln_x"])
        running.log_s1 = state["running_log_s1"]
        running.log_s2 = state["running_log_s2"]
        rng.bit_generator.state = state["rng_state"]
    else:
        # initial live points: uniform draws; -inf starts are resampled in
        # full (n_live, n_params) batches
        u0 = np.array(rng.random((n_live, n_params)))
        lnl0 = lnlike_host(u0)
        bad = ~np.isfinite(lnl0)
        tries = 0
        while bad.any() and tries < 200:
            u_new = rng.random((n_live, n_params))
            l_new = lnlike_host(u_new)
            good_new = np.isfinite(l_new)
            n_take = min(int(bad.sum()), int(good_new.sum()))
            if n_take:
                bad_idx = np.where(bad)[0][:n_take]
                good_idx = np.where(good_new)[0][:n_take]
                u0[bad_idx] = u_new[good_idx]
                lnl0[bad_idx] = l_new[good_idx]
            bad = ~np.isfinite(lnl0)
            tries += 1
        live_u = torch.as_tensor(u0, dtype=dtype, device=dev)
        live_lnl = torch.as_tensor(lnl0, dtype=dtype, device=dev)
        live_lnl_np = live_lnl.cpu().numpy()
        scale = torch.tensor(0.5, dtype=dtype, device=dev)  # whitened units
        dead_u_chunks = [np.zeros((0, n_params), dtype=live_lnl_np.dtype)]
        dead_lnl_chunks = [np.zeros(0, dtype=live_lnl_np.dtype)]
        n_dead_total = 0

    def _terminated():
        # (a) the live points' evidence bound below dlogz and (b) posterior
        # ESS at least min_ess; a dynamic run leaves (b) to its threads
        if running.n_dead == 0:
            return False
        logz_dead, ess_now = running.status(live_lnl_np)
        logz_remain = float(np.max(live_lnl_np)) + running.ln_x
        dlogz_met = np.exp(logz_remain - np.logaddexp(logz_dead, logz_remain)) < dlogz
        return bool(dlogz_met and (dynamic or ess_now >= min_ess))

    def _save(phase, thread_segments=None, dynamic_rounds=0):
        if checkpoint is None:
            return
        _ckpt_save(checkpoint, dict(
            config=ckpt_cfg, phase=phase,
            dead_u=np.concatenate(dead_u_chunks, axis=0), dead_lnl=np.concatenate(dead_lnl_chunks),
            live_u=live_u.cpu().numpy(), live_lnl=live_lnl_np,
            generator_state=g.get_state().numpy().copy(), scale=scale.cpu().numpy(),
            n_dead_total=n_dead_total,
            running_n_dead=running.n_dead, running_ln_x=running.ln_x,
            running_log_s1=running.log_s1, running_log_s2=running.log_s2,
            rng_state=rng.bit_generator.state,
            thread_segments=thread_segments, dynamic_rounds=dynamic_rounds,
        ))

    base_done = state is not None and state["phase"] == "dynamic"
    while not base_done and n_dead_total < hard_cap and not _terminated():
        n_steps = min(chunk_steps, max((hard_cap - n_dead_total) // n_batch, 1))
        du, dl, live_u, live_lnl, scale = _nested_core(
            lnlike_u, live_u, live_lnl, g, scale, n_live, n_steps, n_chains, n_repeat, n_batch=n_batch
        )
        # the chunk's one read-back
        dead_u_chunks.append(du.cpu().numpy())
        dead_lnl_chunks.append(dl.cpu().numpy())
        live_lnl_np = live_lnl.cpu().numpy()
        n_dead_total += n_steps * n_batch
        running.add(dead_lnl_chunks[-1])
        _save("base")

    dead_u = np.concatenate(dead_u_chunks, axis=0)
    dead_lnl = np.concatenate(dead_lnl_chunks)
    live_u_np = live_u.cpu().numpy()
    n_dead = len(dead_lnl)

    # ---- host-side weight/evidence assembly (Skilling 2006)
    order, all_lnl, all_logwt, logz, probs, ess = _assemble_weights(dead_lnl, live_lnl_np, n_live, n_batch=n_batch)
    all_u = np.concatenate([dead_u, live_u_np[order]], axis=0)
    finite = np.isfinite(all_logwt)
    p = np.exp(all_logwt[finite] - logz)
    h = float(np.sum(p * (all_lnl[finite] - logz)))
    logzerr = float(np.sqrt(max(h, 0.0) * _logzerr_scale(n_live, n_batch)))

    # ---- dynamic posterior threads
    dynamic_rounds = 0
    n_iter_total = n_dead
    if dynamic and ess < min_ess:
        segments = [dict(dead_lnl=dead_lnl, live_lnl=live_lnl_np, n_live=n_live, n_batch=n_batch,
                         L0=-np.inf, all_u=all_u)]
        if state is not None and state.get("thread_segments"):
            # completed rounds restore verbatim; an interrupted round replays
            # from its start, where the generator's state was saved
            segments.extend(state["thread_segments"])
            dynamic_rounds = int(state["dynamic_rounds"])
            n_iter_total += sum(len(s["dead_lnl"]) for s in state["thread_segments"])
        merged = None
        while n_dead_total < hard_cap and dynamic_rounds < max_dynamic_rounds:
            if merged is None:
                merged = _merge_segments(segments)
            if merged[5] >= min_ess:
                break
            # thread starts: the merged samples just above the activation
            # threshold, decorrelated by a whitened constrained walk so that
            # thread deaths are fresh draws. A chain that never accepts stays
            # a copy of an existing sample (counted twice by the merge): it
            # is retried at halved step scale before giving up.
            L_lo, s_u, s_lnl = _thread_starts(merged, posterior_frac, n_live)
            t_live_u = torch.as_tensor(s_u, dtype=dtype, device=dev)
            t_live_lnl = torch.as_tensor(s_lnl, dtype=dtype, device=dev)
            chol = _live_cholesky(t_live_u)
            lnl_lo = torch.tensor(L_lo, dtype=dtype, device=dev)
            moved_any = np.zeros(n_live, dtype=bool)
            w_scale = torch.clamp(scale, max=1.0)
            for _ in range(3):
                t_live_u, t_live_lnl, mv, _ = _constrained_walk(
                    lnlike_u, g, t_live_u, t_live_lnl, lnl_lo, w_scale, n_live, 1, 4 * n_repeat, L=chol
                )
                moved_any |= mv.cpu().numpy()
                if moved_any.all():
                    break
                w_scale = w_scale * 0.5
            if not moved_any.all():
                getLogger().warning(
                    "dynamic NS round %d: %d/%d thread starts never moved in the decorrelation walk "
                    "(duplicated samples slightly overweight the merged posterior there).",
                    dynamic_rounds, int((~moved_any).sum()), n_live,
                )
            # the thread run ends on its own dlogz criterion, in prior-mass
            # units relative to the thread
            t_running = _RunningEvidence(n_live, n_batch=n_batch)
            t_dead_u, t_dead_lnl = [], []
            while n_dead_total < hard_cap:
                n_steps = min(chunk_steps, max((hard_cap - n_dead_total) // n_batch, 1))
                du, dl, t_live_u, t_live_lnl, scale = _nested_core(
                    lnlike_u, t_live_u, t_live_lnl, g, scale, n_live, n_steps, n_chains, n_repeat, n_batch=n_batch
                )
                t_dead_u.append(du.cpu().numpy())
                t_dead_lnl.append(dl.cpu().numpy())
                n_dead_total += n_steps * n_batch
                n_iter_total += n_steps * n_batch
                t_running.add(t_dead_lnl[-1])
                t_live_now = t_live_lnl.cpu().numpy()
                t_z, _ = t_running.status(t_live_now)
                t_remain = float(np.max(t_live_now)) + t_running.ln_x
                if np.exp(t_remain - np.logaddexp(t_z, t_remain)) < dlogz:
                    break
            t_live_u_np = t_live_u.cpu().numpy()
            t_live_lnl_np = t_live_lnl.cpu().numpy()
            t_order = np.argsort(t_live_lnl_np)
            segments.append(dict(
                dead_lnl=np.concatenate(t_dead_lnl), live_lnl=t_live_lnl_np, n_live=n_live, n_batch=n_batch,
                L0=L_lo, all_u=np.concatenate(t_dead_u + [t_live_u_np[t_order]], axis=0),
            ))
            dynamic_rounds += 1
            merged = _merge_segments(segments)
            _save("dynamic", thread_segments=segments[1:], dynamic_rounds=dynamic_rounds)
        if merged is not None:
            # the merged assembly is adopted even when no thread ran: the
            # loop judged the single-segment merge's ESS
            all_u, all_lnl, all_logwt, logz, probs, ess, h, logzerr = merged

    truncated = ess < min_ess
    if truncated:
        if dynamic and dynamic_rounds >= max_dynamic_rounds:
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
        n_iter=n_iter_total,
        posterior=params_all[idx],
        logl_posterior=all_lnl[idx],
        ess=ess,
        truncated=truncated,
        dynamic_rounds=dynamic_rounds,
    )
