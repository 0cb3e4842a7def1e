"""Named host spans in the profiler's trace.

``with span("ed.step"): ...`` records a ``torch.profiler.record_function``
range while a torch profiler is recording, which Kineto writes as a
``user_annotation`` event on the clock of the device's kernels. With no
profiler recording, a span is one flag test and a shared no-op context (a
bare ``record_function`` costs microseconds even then). There is no
setting: the spans follow the profiler.
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks its block as ``name`` in a recording
    profiler's trace, or does nothing."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
