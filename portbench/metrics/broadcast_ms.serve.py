"""Mean milliseconds of rank 0's broadcast of a prepared scene to the
other ranks: the program's ``serve.broadcast`` spans (the scene's header
by object broadcast, then its padded PCA cube and spectra by
``dist.broadcast``) that lie wholly inside the traced window.  Rank 0
runs in the benchmark's process, so its spans are the ones recorded."""

from portbench import program_spans

NAME = "serve.broadcast"


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    d = [b - a for a, b in program_spans.inside(t, NAME)]
    return sum(d) / len(d) * 1e-6 if d else None
