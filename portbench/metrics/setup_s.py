"""Set-up: from the process's start to the window (imports, CUDA, the
inputs made from the seed, the program's set-up, warm-up and checked
steps, kernel builds)."""


def read(ctx):
    return ctx.setup_s
