"""Corner plots (counterpart of ``isochrones_tpu/plotting.py``): matplotlib
only, imported at the call, with histograms on the diagonal and 2-d
histograms below it."""

from __future__ import annotations

import numpy as np

__all__ = ["corner"]


def corner(data, labels=None, truths=None, ranges=None, bins=30, quantiles=(0.16, 0.5, 0.84), fig=None, **kwargs):
    """Corner plot of a table (a :class:`~isochrones_torch.summary.Frame`, a
    dict of columns, a ``DataFrame``) or an ``(N, D)`` array.

    truths : optional per-column vertical/crosshair markers
    ranges : optional per-column (lo, hi) plot limits
    """
    import os
    import sys

    import matplotlib

    # Agg only when pyplot is not loaded and there is no display: switching
    # an interactive session to Agg would make every later plt.show() blank
    if "matplotlib.pyplot" not in sys.modules and not os.environ.get("DISPLAY"):
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    if hasattr(data, "keys"):
        cols = list(data.keys())
        if labels is None:
            labels = cols
        x = np.stack([np.asarray(data[c], dtype=float) for c in cols], axis=-1)
    else:
        x = np.asarray(data, dtype=float)
    if x.ndim == 1:  # single-parameter posterior
        x = x[:, None]
    n, d = x.shape
    labels = labels if labels is not None else [f"p{i}" for i in range(d)]

    if ranges is None:
        ranges = []
        for j in range(d):
            col = x[:, j]
            col = col[np.isfinite(col)]
            if len(col) == 0:
                ranges.append((0, 1))
            else:
                lo, hi = np.min(col), np.max(col)
                pad = 0.05 * (hi - lo) or 0.5
                ranges.append((lo - pad, hi + pad))

    if fig is None:
        fig, axes = plt.subplots(d, d, figsize=(2.0 * d, 2.0 * d))
    elif len(fig.axes) == d * d:
        axes = np.array(fig.axes).reshape(d, d)
    else:  # a fresh (or mismatched) figure: make the grid here
        fig.clf()
        axes = np.array(fig.subplots(d, d))
    if d == 1:
        axes = np.array([[axes]]) if not isinstance(axes, np.ndarray) else axes.reshape(1, 1)

    for i in range(d):
        for j in range(d):
            ax = axes[i, j] if d > 1 else axes[0, 0]
            if j > i:
                ax.set_visible(False)
                continue
            if i == j:
                col = x[:, j]
                col = col[np.isfinite(col)]
                if len(col):
                    ax.hist(col, bins=bins, range=ranges[j], histtype="step", color="k", density=True)
                    for q in quantiles or ():
                        ax.axvline(np.quantile(col, q), color="k", ls="--", lw=0.7)
                if truths is not None and truths[j] is not None:
                    ax.axvline(truths[j], color="C0", lw=1.2)
                ax.set_yticks([])
                ax.set_xlim(*ranges[j])
            else:
                good = np.isfinite(x[:, j]) & np.isfinite(x[:, i])
                if good.sum():
                    ax.hist2d(
                        x[good, j], x[good, i], bins=bins,
                        range=[ranges[j], ranges[i]], cmap="Greys",
                    )
                if truths is not None:
                    if truths[j] is not None:
                        ax.axvline(truths[j], color="C0", lw=1.0)
                    if truths[i] is not None:
                        ax.axhline(truths[i], color="C0", lw=1.0)
                ax.set_xlim(*ranges[j])
                ax.set_ylim(*ranges[i])
            if i < d - 1:
                ax.set_xticklabels([])
            else:
                ax.set_xlabel(labels[j])
                ax.tick_params(axis="x", rotation=45)
            if j > 0 or i == 0:
                ax.set_yticklabels([])
            elif i > 0:
                ax.set_ylabel(labels[i])
    fig.subplots_adjust(hspace=0.08, wspace=0.08)
    return fig
