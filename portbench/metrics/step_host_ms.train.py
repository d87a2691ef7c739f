"""Mean milliseconds of a training step's own host work: over the
program's ``train.step`` spans that lie wholly inside the traced window,
each span's length less the union of the CUDA runtime calls (host
records named ``cu*``) inside it.  That is the step's Python, dispatch
and autograd work, whether or not a full launch queue held its calls
back.  Nothing without a runtime record in the window (no card traced)."""

import numpy as np

from portbench import program_spans


def _union(s, e) -> int:
    """Length of the union of intervals sorted by start."""
    reach = np.maximum.accumulate(e)
    first = np.flatnonzero(np.r_[True, s[1:] > reach[:-1]])
    ends = np.r_[reach[first[1:] - 1], reach[-1]]
    return int((ends - s[first]).sum())


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    steps = program_spans.inside(t, "train.step")
    rt = np.array([n.startswith("cu") for n in t.cpu_names], bool)
    if not steps or not rt.any():
        return None
    order = np.argsort(t.cpu_start[rt], kind="stable")
    start, end = t.cpu_start[rt][order], t.cpu_end[rt][order]
    reach = np.maximum.accumulate(end)
    own = []
    for a, b in steps:
        hi = np.searchsorted(start, b)
        lo = np.searchsorted(start, a)
        while lo > 0 and reach[lo - 1] > a:   # calls begun before the step
            lo -= 1
        s = np.clip(start[lo:hi], a, b)
        e = np.clip(end[lo:hi], a, b)
        keep = e > s
        covered = _union(s[keep], e[keep]) if keep.any() else 0
        own.append(b - a - covered)
    return float(np.mean(own)) * 1e-6
