"""Mean seconds of a request's file work in the serve loop: the mean of
the program's ``serve.read`` spans (``np.load`` of the cube) plus the
mean of its ``serve.write`` spans (the map's ``.npy`` and the response
line), over the spans that lie wholly inside the traced window."""

from portbench import program_spans

PARTS = ("serve.read", "serve.write")


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    means = []
    for part in PARTS:
        d = [b - a for a, b in program_spans.inside(t, part)]
        if not d:
            return None
        means.append(sum(d) / len(d))
    return sum(means) * 1e-9
