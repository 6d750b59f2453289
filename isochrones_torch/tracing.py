"""Named spans of the port's layers, in the trace of ``torch.profiler``.

A span is a ``torch.profiler.record_function`` named :data:`PREFIX` + its
name, opened only while a profiler records; otherwise :func:`span` hands back
one shared no-op context, so an untraced fit pays a function call and a flag
read a span. The spans sit on the profiler's clock beside the card's kernels
and copies, so an idle stretch of the card can be put down to the innermost
span that covers it. To read them, wrap the work in the profiler::

    with torch.profiler.profile() as prof:
        fitter.fit_multinest(...)
    spans = [e for e in prof.events() if e.name.startswith("isochrones_torch.")]

A count is the number of spans of one name in the traced window. The spans
change no arithmetic and draw no random numbers: a fit under the profiler is
bitwise the fit without it.
"""

from __future__ import annotations

import contextlib
import functools

import torch

__all__ = ["PREFIX", "span", "spanned"]

PREFIX = "isochrones_torch."
_OFF = contextlib.nullcontext()


def span(name):
    """The span ``PREFIX + name`` while a profiler records, else a no-op."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF


def spanned(name):
    """A decorator: every call of the function inside :func:`span` ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap
