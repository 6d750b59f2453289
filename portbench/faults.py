"""Faults planted under the timed path, to show that the check catches them.

Each is a context manager that patches the program while it is active:

- ``answer``: an answer altered where it is produced (every posterior value
  of the call raised by 0.01);
- ``half``: half of the batch left out (the posterior computed on the first
  half of the walkers, or of the stars, and the rest given the mean of that
  half);
- ``stuck``: a sampler step that returns its state unchanged (the nested
  walk hands back its starting points).

The benchmark's own runs use none of them: the tests and ``calibrate`` do.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def _answer(orig):
    def fn(*args, **kwargs):
        return orig(*args, **kwargs) + 0.01
    return fn


def _half_rows(orig):
    """A posterior whose output's leading rows past the first half are the
    mean of the first half's finite values."""
    def fn(self, x, *rest, **kwargs):
        out = orig(self, x, *rest, **kwargs)
        h = (out.shape[0] + 1) // 2
        head = out[:h]
        fill = torch.where(torch.isfinite(head), head, torch.zeros_like(head)).mean(dim=0)
        return torch.cat([head, fill.expand((out.shape[0] - h,) + out.shape[1:])])
    return fn


def _stuck(orig):
    def fn(lnlike_fam, g, start, lnl_start, lnl_star, scale, n_groups, n_chains, n_repeat, L=None):
        _, _, moved, acc = orig(lnlike_fam, g, start, lnl_start, lnl_star, scale, n_groups, n_chains, n_repeat, L=L)
        M, p = start.shape[0], start.shape[-1]
        x = start.reshape(M, n_groups, n_chains, p)[:, :, 0]
        lnl = lnl_start.reshape(M, n_groups, n_chains)[:, :, 0]
        return x, lnl, torch.zeros_like(moved), acc
    return fn


def plant(kind, family):
    """The context manager that plants fault ``kind`` in the path of the
    configuration family ``family`` ("cluster" or "catalog")."""
    if family == "cluster":
        from isochrones_torch.cluster import StarClusterModel as owner

        name = "lnpost_batch"
    else:
        from isochrones_torch.batch import BatchStarFitter as owner

        name = "_lnpost"
    if kind == "answer":
        return _patched(owner, name, _answer)
    if kind == "half":
        return _patched(owner, name, _half_rows)
    if kind == "stuck" and family == "catalog":
        from isochrones_torch.samplers import nested

        return _patched(nested, "_constrained_walk_family", _stuck)
    raise ValueError(f"no fault {kind!r} for the {family} family")
