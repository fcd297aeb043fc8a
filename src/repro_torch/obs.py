"""The program's spans: ``torch.profiler`` ranges at its layer boundaries.

``span(name, args)`` is a context manager.  While a ``torch.profiler`` session
records on this thread it is ``torch.profiler.record_function(name, args)``, so
the range lands in that session's trace beside the device's kernels, on one
clock.  Otherwise it is one shared ``contextlib.nullcontext()``: a span then
costs one check of the profiler's state, builds nothing and formats nothing.

There is no switch, buffer or exporter here: whatever profiler session runs
collects the spans.  ``PERF.md`` section 3 lists every span and what reads it.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str, args: Callable[[], str] | tuple | None = None):
    """A profiler range named ``name`` while a profiler records, else a shared no-op.

    ``args`` is formatted only while recording: a callable returning the string,
    or a tuple of alternating names and values (``("layer", 3)`` -> ``"layer=3"``).
    """
    if not _recording():
        return _OFF
    if callable(args):
        args = args()
    elif isinstance(args, tuple):
        args = " ".join(f"{k}={v}" for k, v in zip(args[::2], args[1::2]))
    return torch.profiler.record_function(name, args)
