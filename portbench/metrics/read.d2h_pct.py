"""Share of the reads' device time that is copies from the device to the
host (the fused read's candidate block), from the profiler's trace."""


def read(ctx):
    dev = ctx.trace.get("device_s", 0.0)
    return 100.0 * ctx.trace["d2h_s"] / dev if dev > 0 else None
