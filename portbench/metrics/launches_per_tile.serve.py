"""Kernel launches a tile of the scene map: the CUDA runtime's launch
calls (``cudaLaunchKernel*``, ``cuLaunchKernel*``, a ``cudaGraphLaunch``
as one) that start inside the program's ``map.tile`` spans (a tile's
gather, forward and argmax) lying wholly inside the traced window, over
those tiles.  Nothing without a runtime record in the window (no card
traced), or from a program without the span."""

import numpy as np

from portbench import program_spans

LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch")


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    tiles = program_spans.inside(t, "map.tile")
    if not tiles or not any(n.startswith("cu") for n in t.cpu_names):
        return None
    sel = np.array([n.startswith(LAUNCH) for n in t.cpu_names], bool)
    start = np.sort(t.cpu_start[sel])
    a, b = np.array(tiles, np.int64).T
    n = np.searchsorted(start, b) - np.searchsorted(start, a)
    return float(n.sum()) / len(tiles)
