"""Training patches (labeled + unlabeled, every seed) that the window's
completed steps consumed, over the whole window on the host's clock."""


def read(ctx):
    w = ctx.window
    return w["samples"] / w["seconds"]
