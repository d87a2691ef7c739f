"""Mean seconds a request's map holds the device: for each request of
the traced window, the span from the first to the last device record
that starts between its line's writing and its response's reading."""


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    spans = [t.span(a, b) for a, b in ctx.window["spans_ns"]]
    spans = [s for s in spans if s is not None]
    return sum(spans) / len(spans) if spans else None
