"""Spans of the serving path, on while a torch profiler runs.

``span(name)`` is a ``torch.profiler.record_function`` range when a
profiler is recording and one shared no-op context otherwise, so a span
site costs one flag read outside a trace (an ungated
``record_function`` costs tens of times that to enter and exit even
with no profiler).  The ranges lie in the profiler's timeline beside the device
operations and the runtime calls that launched them, on one clock.
There is no switch of the program's own: a profiler turns them on.
"""
from __future__ import annotations

import contextlib

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` as a range while a profiler runs."""
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF
