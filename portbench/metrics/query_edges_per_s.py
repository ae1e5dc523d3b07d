"""Entries of every read answer returned in the window, over the window's
seconds: Fig. 4's query rate."""


def read(ctx):
    if not ctx.latencies("read").size:
        return None
    return ctx.entries("read") / ctx.window_s
