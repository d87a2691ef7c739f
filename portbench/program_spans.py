"""The program's own spans in a traced window, for the readers of
``prep_s.serve``, ``io_s.serve`` and the ``*.train`` step metrics.

The port records its spans itself (``cmlpl_tpu_torch/utils/profiling``:
``span`` while a ``torch.profiler`` session runs, on ``time.time_ns``, the
clock of the profiler's records) and hands them over through
``take_spans``.  The first reader of a window takes them; the others read
the same list.  A program without a recorder gives none, and its readers
return nothing.
"""

from __future__ import annotations

import weakref

_TAKEN: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _taken(trace) -> list:
    """(name, start, end) of every program span that overlaps the
    trace's window, taken from the program once a trace."""
    if trace not in _TAKEN:
        try:
            from cmlpl_tpu_torch.utils.profiling import take_spans
        except ImportError:
            spans = []
        else:
            spans = [(s.name, s.start_ns, s.end_ns)
                     for s in take_spans(trace.t0, trace.t1)]
        _TAKEN[trace] = spans
    return _TAKEN[trace]


def inside(trace, name: str) -> list:
    """(start, end) in ns of the program's spans ``name`` that lie wholly
    inside the trace's window, in order of start."""
    return [(a, b) for n, a, b in _taken(trace)
            if n == name and a >= trace.t0 and b <= trace.t1]
