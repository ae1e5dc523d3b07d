"""Process start to the window's start: imports, the kernel build or
load, the data, the preload and the warm-up."""


def read(ctx):
    return ctx.setup_s
