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
bitwise the fit without it. While the current CUDA stream captures a graph,
:func:`span` is the no-op too: a span there would time the enqueue of work
that runs later, at each replay.
"""

from __future__ import annotations

import contextlib
import functools

import torch

__all__ = ["PREFIX", "span", "spanned"]

PREFIX = "isochrones_torch."
_OFF = contextlib.nullcontext()


def _capturing():
    """Whether the current CUDA stream is capturing a graph."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def span(name):
    """The span ``PREFIX + name`` while a profiler records and no graph is
    being captured, else a no-op."""
    if torch._C._autograd._profiler_enabled() and not _capturing():
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
