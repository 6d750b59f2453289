"""Whole catalogue fits back to back: ``fit_catalog``'s three steps.

Set-up makes the catalogue (the configuration's truths, drawn in its box
from its own seed, in that order; observations the reference's
interpolation at the truths, no noise, and the configuration's holes at
fixed rows) and warms every step with a fit cut short. Each fit of the
window is ``BatchStarFitter(ic, catalogue)``, its ``fit_multinest`` with the
traffic's settings written out, the sampler's seed among them, and
``summarize_batch`` with the derived columns. So every fit of every run does
the same work, whatever the run's seed: the seed draws the check's sample.
The window's last fit is finished when the time runs out, and the rate is
the stars of every fit over the whole time. The check takes a sample of
stars drawn from the seed (and the stars with holes) from every fit, and
recomputes their posterior at the returned draws, the summary's quantiles
from those draws, and the derived columns at them; and it asks that the
draws sit where the posterior is: the posterior at the truth less its median
over the draws.
"""

from __future__ import annotations

import dataclasses
import sys
import time
import types

import numpy as np
import torch

from ..reference.catalog import Posterior, quantiles
from ..reference.interp import magnitudes
from ..trace import Trace, profiled, span, window
from . import common

PARAMS = ("eep", "age", "feh", "distance", "AV")


@dataclasses.dataclass
class State:
    ic: object
    tables: dict
    catalog: dict
    obs: dict
    truths: np.ndarray
    keep: np.ndarray
    cfg: dict
    traffic: dict
    seed: int
    device: torch.device
    compile_s: float
    fits: list = dataclasses.field(default_factory=list)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def catalogue(cfg, tables, device):
    """``(truths (S, 5), program columns, reference observations)``. The
    truths are the configuration's (drawn from its own ``seed``), so every
    run fits the same stars in the same order."""
    c = cfg["catalog"]
    S, bands = c["n_stars"], list(cfg["bands"])
    rng = common.seeded(c["seed"], 2)
    box = c["truth_box"]
    truths = np.stack([rng.uniform(lo, hi, S) for lo, hi in box], axis=-1)
    dt = tables["iso"][0].dtype
    for _ in range(50):
        x = torch.as_tensor(truths, dtype=dt, device=device)
        Teff, logg, _, mags = magnitudes(tables["iso"], tables["bc"], x, tables["band_cols"])
        bad = (~(torch.isfinite(mags).all(-1) & torch.isfinite(Teff))).cpu().numpy()
        if not bad.any():
            break
        truths[bad] = np.stack([rng.uniform(lo, hi, int(bad.sum())) for lo, hi in box], axis=-1)
    else:
        raise RuntimeError("catalogue truths: no finite magnitudes after 50 draws")
    mags, Teff, logg = (t.cpu().numpy().astype(float) for t in (mags, Teff, logg))
    err = c["errors"]
    cols = {}
    for j, b in enumerate(bands):
        cols[f"{b}_mag"], cols[f"{b}_mag_unc"] = mags[:, j].copy(), np.full(S, err["mag"])
    cols["Teff"], cols["Teff_unc"] = Teff, np.full(S, err["Teff"])
    cols["logg"], cols["logg_unc"] = logg, np.full(S, err["logg"])
    cols["parallax"], cols["parallax_unc"] = 1000.0 / truths[:, 3], np.full(S, err["parallax"])
    idx = np.arange(S)
    h = c["holes"]
    cols[f"{h['band']}_mag"][idx % h["band_every"] == h["band_at"]] = np.nan
    cols["parallax"][idx % h["parallax_every"] == h["parallax_at"]] = np.nan
    cols["Teff"][h["no_teff"]] = np.nan
    for b in bands:
        cols[f"{b}_mag"][h["no_bands"]] = np.nan
    obs = dict(mag_vals=np.stack([cols[f"{b}_mag"] for b in bands], -1),
               mag_uncs=np.stack([cols[f"{b}_mag_unc"] for b in bands], -1),
               spec_vals=np.stack([cols["Teff"], cols["logg"], np.full(S, np.nan)], -1),
               spec_uncs=np.stack([cols["Teff_unc"], cols["logg_unc"], np.full(S, np.nan)], -1),
               plax=cols["parallax"], plax_unc=cols["parallax_unc"])
    return truths, cols, obs


def _fit(state, nested=None):
    """One whole fit; returns its record (the kept stars' draws, posterior
    values and summary, the fit's seconds and its stars without support)."""
    from isochrones_torch.batch import BatchStarFitter
    from isochrones_torch.summary import summarize_batch

    tr = state.traffic
    t0 = time.perf_counter()
    with span("BatchStarFitter"):
        fitter = BatchStarFitter(state.ic, state.catalog)
    settings = dict(tr["nested"], **(nested or {}))
    with span("fit_multinest"):
        info = fitter.fit_multinest(**settings)
    t1 = time.perf_counter()
    with span("summarize_batch"):
        summary = summarize_batch(fitter, qs=tuple(tr["quantiles"]), derived=True)
    t2 = time.perf_counter()
    samples = np.asarray(fitter.samples)
    keep = state.keep
    return dict(fit_s=t1 - t0, summary_s=t2 - t1, n_dead=info["n_dead"],
                unsupported=int(np.isnan(samples).any(axis=(1, 2)).sum()), samples=samples[keep],
                lnprob=np.asarray(fitter._lnprob)[keep], summary={c: np.asarray(v)[keep] for c, v in summary.items()},
                fitter=fitter)


def setup(cfg, traffic, seed, device):
    compile_s = common.build_kernels(device)
    ic, tables = common.interpolator(cfg, device)
    truths, cols, obs = catalogue(cfg, tables, device)
    state = State(ic, tables, cols, obs, truths, None, cfg, traffic, seed, device, compile_s)
    reseed(state, seed)
    # every step of a fit, cut short: the start's and the walks' posterior
    # calls, a chunk's read-backs, the weights, the resampling and a summary
    # of fewer draws (the program compiles nothing at run time; this warms the
    # library, the allocator and the host code)
    _fit(state, nested=dict(max_iter=traffic["warmup_dead_points"], n_equal=traffic["warmup_draws"]))
    state.sync()
    return state


def reseed(state, seed):
    """A new check sample from ``seed``, with no fit made."""
    cfg = state.cfg
    state.seed = seed
    S = cfg["catalog"]["n_stars"]
    n_keep = min(cfg["check"]["stars"], S)
    state.keep = np.union1d(common.seeded(seed, 4).choice(S, size=n_keep, replace=False),
                            [i for i in cfg["check"]["always"] if i < S])
    state.fits = []


def _window(state, seconds):
    t0 = time.perf_counter()
    while True:
        rec = _fit(state)
        del rec["fitter"]
        state.fits.append(rec)
        print(f"fit {len(state.fits)}: {rec['fit_s']:.3f} s fit, {rec['summary_s']:.3f} s summary, "
              f"{rec['n_dead']} dead points", file=sys.stderr)
        if time.perf_counter() - t0 >= seconds:
            break
    return time.perf_counter() - t0


def measure(state, seconds):
    elapsed = _window(state, seconds)
    S = state.cfg["catalog"]["n_stars"]
    n = len(state.fits) * S
    return types.SimpleNamespace(values={"catalog_stars_per_s": n / elapsed}, attempted=n,
                                 failed=sum(f["unsupported"] for f in state.fits))


def traced(state, seconds):
    """One whole fit under the profiler; then the posterior alone at the
    traffic's walk shape (the fit's own draws), timed by CUDA events and
    profiled for its kernel's device time."""
    with profiled() as prof:
        with window():
            rec = _fit(state)
    fitter = rec.pop("fitter")
    state.fits.append(rec)
    tr = state.traffic
    x = torch.as_tensor(fitter.samples[:, :tr["walk_points"]], dtype=state.ic.dtype, device=state.device)
    reps = tr["lnpost_calls"]
    for _ in range(3):
        fitter.lnpost_batch(x)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fitter.lnpost_batch(x)
    end.record()
    torch.cuda.synchronize()
    with profiled() as prof2:
        with window():
            for _ in range(reps):
                fitter.lnpost_batch(x)
    S = state.cfg["catalog"]["n_stars"]
    terms = np.isfinite(np.concatenate([state.obs["mag_vals"], state.obs["spec_vals"], state.obs["plax"][:, None]],
                                       axis=1)).sum(axis=1)
    return types.SimpleNamespace(trace=Trace(prof), fit=rec, lnpost_ms=start.elapsed_time(end) / reps,
                                 lnpost_trace=Trace(prof2), lnpost_calls=reps, walk_x=x, terms=terms,
                                 tables=state.tables, cfg=state.cfg, attempted=S, failed=rec["unsupported"])


def release(state):
    """Free the program's state: the interpolator and its tables' copies."""
    state.ic = None


def check(state, cfg, control=False):
    """The compared numbers; with ``control`` the reference computed in
    float32 stands in the program's place for the posterior values and the
    derived columns."""
    fits = state.fits
    post = Posterior(state.tables, state.obs, cfg)
    post32 = Posterior(common.as_dtype(state.tables, torch.float32), state.obs, cfg) if control else None
    keep = state.keep
    dev, dt = post.device, post.dtype
    derived = cfg["check"]["derived"]
    qs = state.traffic["quantiles"]
    lnpost_gap = q_gap = 0.0
    mismatch = 0
    truth_gap = []
    stars = torch.as_tensor(keep, device=dev)
    at_truth = post(torch.as_tensor(state.truths[keep][:, None, :], dtype=dt, device=dev), stars).cpu().numpy()[:, 0]

    def blocks(fn, x):
        return torch.cat([fn(x[i:i + 64], stars[i:i + 64]) for i in range(0, len(keep), 64)]).cpu().numpy()

    for f in fits:
        x = torch.as_tensor(f["samples"], dtype=dt, device=dev)
        want = blocks(post, x)
        prog = f["lnprob"] if post32 is None else blocks(post32, x.to(torch.float32))
        g, m = common.gaps(prog, want)
        lnpost_gap, mismatch = max(lnpost_gap, g), mismatch + m
        ok = np.isfinite(want).any(axis=1)
        truth_gap.append(float(np.median(at_truth[ok] - np.median(want[ok], axis=1))))
        draws = f["samples"]
        n = draws.shape[1]
        sub = draws[:, np.linspace(0, n - 1, min(n, 2000)).astype(int)] if n > 2000 else draws
        dvals = blocks(lambda v, _: post.derived(v, derived), torch.as_tensor(sub, dtype=dt, device=dev))
        summary = f["summary"]
        if post32 is not None:
            d32 = blocks(lambda v, _: post32.derived(v, derived), torch.as_tensor(sub, dtype=torch.float32, device=dev))
            summary = dict(summary)
            for i, c in enumerate(derived):
                for q, row in zip(qs, quantiles(d32[..., i], qs)):
                    summary[f"{c}_{q * 100:02.0f}"] = row
        named = [(p, draws[..., i]) for i, p in enumerate(PARAMS)] + [(c, dvals[..., i]) for i, c in enumerate(derived)]
        for name, vals in named:
            for q, row in zip(qs, quantiles(vals, qs)):
                g, m = common.gaps(summary[f"{name}_{q * 100:02.0f}"], row)
                q_gap, mismatch = max(q_gap, g), mismatch + m
    lim = cfg["check"]["limits"]
    return {"lnpost_gap": {"value": lnpost_gap, "limit": lim["lnpost_gap"]},
            "quantile_gap": {"value": q_gap, "limit": lim["quantile_gap"]},
            "truth_gap": {"value": max(truth_gap), "limit": lim["truth_gap"]},
            "finite_mismatch": {"value": mismatch, "limit": 0}}
