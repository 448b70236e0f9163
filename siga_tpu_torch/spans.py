"""Named spans of the program's host work, in a `torch.profiler` trace.

`span(name)` is a context manager.  While a profiler records, it is a range
of the profiler's own (`_RecordFunctionFast`), recorded as a host operation
of the trace: it shares the trace's clock with the device's activity, and a
reduction of the trace that keeps the torch operations and CUDA runtime
calls keeps it beside them, nested around those it holds.  With no profiler
it is one shared no-op: nothing is recorded, allocated or timed.  The trace
is the only store; the program exports nothing.
"""
from __future__ import annotations

from contextlib import nullcontext

import torch
from torch.autograd import profiler as _profiler

_OFF = nullcontext()


def span(name: str):
    """A span named `name` while a profiler records (torch's
    profiler-enabled flag, which `torch.profiler.profile` sets), else the
    shared no-op."""
    if _profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF
