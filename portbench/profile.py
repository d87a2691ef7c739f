"""The traced run's window: ``torch.profiler`` over the measured window,
and what the per-layer readers take from it.

The profiler starts before the window and waits :data:`SETTLE_S` first:
CUPTI may drop the records of kernels launched in a session's first
moments.  The window's bounds are read on the host's wall clock in
nanoseconds, the clock the profiler's records carry.  Device activity
is every record on the card (kernels, copies, sets); its busy time is
the union of their intervals inside the window, so kernels that overlap
count once.

On the card only the CUDA activity is traced (the device's records and
the CUDA runtime's calls), not every host op: recording each ATen op
slowed SSRN's host-paced steps by 80% and so misstated the idle share it
was there to read.  The host side of an idle gap is named by the
benchmark's own spans around its calls into the program
(:meth:`Profiled.span`) and the runtime call that covers it.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

#: seconds between the profiler's start and the window
SETTLE_S = 0.1


class Trace:
    """Device records and host ops of one profiled window, as numpy
    arrays of ns on the wall clock (``dev_*``: names, starts, ends;
    ``cpu_*`` likewise), clipped to nothing: callers clip to
    ``[t0, t1]``."""

    def __init__(self, events, t0: int, t1: int, spans=()):
        self.t0, self.t1 = t0, t1
        self.spans = list(spans)
        dev, cpu = [], []
        for e in events:
            rec = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append(rec)
            elif e.device_type() == torch.autograd.DeviceType.CPU:
                cpu.append(rec)
        self.dev_names, self.dev_start, self.dev_end = _arrays(dev)
        self.cpu_names, self.cpu_start, self.cpu_end = _arrays(cpu)
        inside = (self.dev_end > t0) & (self.dev_start < t1)
        self.dev_names = [n for n, k in zip(self.dev_names, inside) if k]
        self.dev_start = np.maximum(self.dev_start[inside], t0)
        self.dev_end = np.minimum(self.dev_end[inside], t1)
        self.busy = _union(self.dev_start, self.dev_end)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    @property
    def busy_s(self) -> float:
        return float(sum(b - a for a, b in self.busy)) * 1e-9

    def kernel_seconds(self, needle: str) -> tuple[int, float]:
        """(records, summed seconds) of device records whose name holds
        ``needle``."""
        sel = np.array([needle in n for n in self.dev_names], bool)
        return int(sel.sum()), float(
            (self.dev_end[sel] - self.dev_start[sel]).sum()) * 1e-9

    def span(self, a: int, b: int) -> float | None:
        """Seconds from the first to the last device record that starts
        in [a, b), or None."""
        sel = (self.dev_start >= a) & (self.dev_start < b)
        if not sel.any():
            return None
        return float(self.dev_end[sel].max() - self.dev_start[sel].min()) \
            * 1e-9

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, summed by name, and the
        longest idle gaps, each named by :meth:`_host_op`."""
        totals: dict = {}
        for n, a, b in zip(self.dev_names, self.dev_start, self.dev_end):
            totals[n] = totals.get(n, 0) + int(b - a)
        ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
        edges = [self.t0] + [x for ab in self.busy for x in ab] + [self.t1]
        gaps = sorted(((edges[i], edges[i + 1])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]),
                      key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, t * 1e-9] for n, t in ops],
                "idle_gaps": [[self._host_op(a, b), (b - a) * 1e-9]
                              for a, b in gaps]}

    def _host_op(self, a: int, b: int) -> str:
        """"<span> / <host op>": the innermost benchmark span and host op
        (a runtime call on the card) that each cover half of [a, b) or
        more; "-" for none."""
        def inner(names, start, end):
            over = np.minimum(end, b) - np.maximum(start, a)
            cand = np.flatnonzero(over >= 0.5 * (b - a))
            if not len(cand):
                return "-"
            return names[cand[np.argmin(end[cand] - start[cand])]]

        names, start, end = _arrays(self.spans)
        return (inner(names, start, end) + " / "
                + inner(self.cpu_names, self.cpu_start, self.cpu_end))


def _arrays(recs):
    if not recs:
        return [], np.zeros(0, np.int64), np.zeros(0, np.int64)
    names, a, b = zip(*recs)
    return list(names), np.asarray(a, np.int64), np.asarray(b, np.int64)


def _union(start: np.ndarray, end: np.ndarray) -> list:
    """The union of the intervals as sorted disjoint (a, b) pairs."""
    out: list = []
    for a, b in sorted(zip(start.tolist(), end.tolist())):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


class Profiled:
    """``with Profiled(device) as p:`` profiles the block, whose window
    starts after :data:`SETTLE_S`; ``p.mark_end()`` closes the window
    (else the block's end does), and ``p.trace`` holds the result."""

    def __init__(self, device: torch.device):
        self.device = device
        self.trace: Trace | None = None
        self.t1: int | None = None
        self.spans: list = []

    @contextlib.contextmanager
    def span(self, name: str):
        """Records the block as a host span ``name``."""
        a = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, a, time.time_ns()))

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA if self.device.type == "cuda"
                else ProfilerActivity.CPU]
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        time.sleep(SETTLE_S)
        _sync(self.device)
        self.t0 = time.time_ns()
        return self

    def mark_end(self) -> None:
        _sync(self.device)
        self.t1 = time.time_ns()

    def __exit__(self, *exc):
        if self.t1 is None:
            self.mark_end()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = Trace(self._prof.profiler.kineto_results.events(),
                               self.t0, self.t1, self.spans)
        return False


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
