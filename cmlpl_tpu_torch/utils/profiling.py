"""Profiling and step timing (``cmlpl_tpu/utils/profiling.py``).

The reference's only instrumentation is wall-clock prints around inference
(``train.py:290-293``).  :func:`trace` captures the enclosed block with
``torch.profiler`` (the host and, on the card, its kernels through CUPTI)
and writes it as a Chrome trace JSON, readable in Perfetto or
``chrome://tracing``.  Unlike ``jax.profiler``'s trace it writes no
TensorBoard plugin file: the card's machine has no TensorBoard package.
:class:`StepTimer` synchronises the device before it reads the clock, so
step times count the device's work, not just its launches.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch
from torch.utils._pytree import tree_leaves


#: seconds to wait after ``torch.profiler`` starts tracing the card and
#: before the work it should see: CUPTI may drop the records of kernels
#: launched in its first moments (``python -m
#: cmlpl_tpu_torch.utils.profiler_check`` counts the sessions that lose
#: some, with and without this wait)
CUPTI_SETTLE_S = 0.1


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block (host ops, and CUDA kernels where CUDA
    is available) into ``<log_dir>/trace_<time>_<pid>.json``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        if torch.cuda.is_available():
            time.sleep(CUPTI_SETTLE_S)
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}"
        ".json"))


def synchronize(tree) -> None:
    """Waits for the device of the first tensor in ``tree`` (a tensor or
    nested containers of them) when it is a CUDA one."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
            return


class StepTimer:
    """Per-step wall time; ``stop(sync_on)`` first waits for the device of
    ``sync_on`` (:func:`synchronize`)."""

    def __init__(self):
        self.times: list[float] = []
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, sync_on=None) -> float:
        if sync_on is not None:
            synchronize(sync_on)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)
