"""Kernel launches a training step: the CUDA runtime's launch calls
(``cudaLaunchKernel*``, ``cuLaunchKernel*``, a ``cudaGraphLaunch`` as one)
that start inside the program's ``train.step`` spans lying wholly inside
the traced window, over those steps.  Nothing without a runtime record
in the window (no card traced)."""

import numpy as np

from portbench import program_spans

LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch")


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    steps = program_spans.inside(t, "train.step")
    if not steps or not any(n.startswith("cu") for n in t.cpu_names):
        return None
    sel = np.array([n.startswith(LAUNCH) for n in t.cpu_names], bool)
    start = np.sort(t.cpu_start[sel])
    a, b = np.array(steps, np.int64).T
    n = np.searchsorted(start, b) - np.searchsorted(start, a)
    return float(n.sum()) / len(steps)
