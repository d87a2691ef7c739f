"""Mean seconds on the client's clock from writing a request's line to
reading its response's line, over every request of the window, failed
ones too."""


def read(ctx):
    lat = ctx.window["latencies"]
    return sum(lat) / len(lat) if lat else None
