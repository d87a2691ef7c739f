"""Profiling and program spans (``cmlpl_tpu/utils/profiling.py``).

The reference's only instrumentation is wall-clock prints around inference
(``train.py:290-293``).  :func:`trace` captures the enclosed block with
``torch.profiler`` (the host and, on the card, its kernels through CUPTI)
and writes it as a Chrome trace JSON, readable in Perfetto or
``chrome://tracing``.  Unlike ``jax.profiler``'s trace it writes no
TensorBoard plugin file: the card's machine has no TensorBoard package.

:func:`span` names a part of the program's host code (a request's prep, a
step's backward) while a ``torch.profiler`` session is running, on the
clock the profiler's records carry (``time.time_ns``), so a gap in the
device's activity can be named by the host code that was running.  The
spans nest per thread; :func:`take_spans` hands them over, and
:func:`trace` writes its session's into the Chrome trace on a row of
their own.  With no session running a span records nothing: ``span``
returns one shared no-op context and reads no clock.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Iterator

import torch
import torch.autograd.profiler as _profiler


#: seconds to wait after ``torch.profiler`` starts tracing the card and
#: before the work it should see: CUPTI may drop the records of kernels
#: launched in its first moments (``python -m
#: cmlpl_tpu_torch.utils.profiler_check`` counts the sessions that lose
#: some, with and without this wait)
CUPTI_SETTLE_S = 0.1

#: the most finished spans kept between two :func:`take_spans` (older ones
#: are dropped): a session that nobody hands over, such as a profiler
#: outside :func:`trace`, holds no more than this
MAX_SPANS = 1 << 17

#: the Chrome trace's row of :func:`trace`'s spans (above any thread id)
SPAN_TID = 1 << 30

_NOOP = contextlib.nullcontext()
_FINISHED: collections.deque = collections.deque(maxlen=MAX_SPANS)
_INDEX = itertools.count()
_LOCAL = threading.local()


class Span:
    """One recorded span: ``name``, ``start_ns`` and ``end_ns`` on
    ``time.time_ns``, its ``index`` (unique in the process), its
    ``parent``'s index and its ``root``'s (None and its own for a root;
    every span of one request or one training call shares the root's),
    the ``thread`` it ran on and its ``attrs``."""

    __slots__ = ("name", "attrs", "index", "parent", "root", "thread",
                 "start_ns", "end_ns")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.index = next(_INDEX)

    def __enter__(self) -> "Span":
        stack = _LOCAL.__dict__.setdefault("stack", [])
        self.parent = stack[-1].index if stack else None
        self.root = stack[0].index if stack else self.index
        self.thread = threading.get_ident()
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        _LOCAL.stack.pop()
        _FINISHED.append(self)
        return False


def span(name: str, **attrs):
    """``with span("train.step", epoch=e):`` records the block as a
    :class:`Span` while a ``torch.profiler`` session is running; otherwise
    it is the shared no-op context.

    The gate is the profiler's process-wide flag, set at a session's start
    and cleared at its end.  (``torch._C._autograd._profiler_enabled()``
    is per thread: it reads False on a thread started before the session,
    such as the serving loop's thread in a client that profiles around
    it.)"""
    if not _profiler._is_profiler_enabled:
        return _NOOP
    return Span(name, attrs)


def take_spans(t0: int | None = None, t1: int | None = None) -> list:
    """The finished spans that overlap [``t0``, ``t1``] (ns on
    ``time.time_ns``; None: unbounded), ordered by start, and forgets
    every finished span.  A span still open is handed over by the next
    call after it ends."""
    done = [_FINISHED.popleft() for _ in range(len(_FINISHED))]
    lo = -1 if t0 is None else t0
    hi = float("inf") if t1 is None else t1
    return sorted((s for s in done if s.end_ns >= lo and s.start_ns <= hi),
                  key=lambda s: (s.start_ns, s.index))


def _add_spans(path: str, spans: list) -> None:
    """Writes ``spans`` into the Chrome trace at ``path`` as complete
    events on the trace's time base, under the process's own id on a row
    of their own a recording thread (``tid`` :data:`SPAN_TID` + k, named
    "program spans k"); no spans leave the file as it is."""
    if not spans:
        return
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    rows: dict = {}
    events = doc.setdefault("traceEvents", [])
    for s in spans:
        if s.thread not in rows:
            rows[s.thread] = SPAN_TID + len(rows)
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": rows[s.thread],
                           "args": {"name": f"program spans {len(rows) - 1}"}})
        events.append({
            "ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
            "tid": rows[s.thread], "ts": (s.start_ns - base) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": {"index": s.index, "parent": s.parent, "root": s.root,
                     **{k: str(v) for k, v in s.attrs.items()}}})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block (host ops, and CUDA kernels where CUDA
    is available) into ``<log_dir>/trace_<time>_<pid>.json``, with the
    program's spans of the block on rows of their own."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.time_ns()
        if torch.cuda.is_available():
            time.sleep(CUPTI_SETTLE_S)
        yield prof
    path = os.path.join(
        log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}"
        ".json")
    prof.export_chrome_trace(path)
    _add_spans(path, take_spans(t0))
