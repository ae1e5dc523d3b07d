"""Triples handed to every put that returned in the window, over the
window's seconds (duplicates count, as the paper counts inserts)."""


def read(ctx):
    if not ctx.latencies("put").size:
        return None
    return ctx.entries("put") / ctx.window_s
