"""Mean seconds of a request's host prep: the program's ``serve.prep``
spans (``data/prep.prepare_scene``: the PCA and its z-score, the
spectra's z-score, the pad and the upload) that lie wholly inside the
traced window."""

from portbench import program_spans

NAME = "serve.prep"


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    d = [b - a for a, b in program_spans.inside(t, NAME)]
    return sum(d) / len(d) * 1e-9 if d else None
