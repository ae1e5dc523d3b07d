"""95th percentile of the latency of all reads in the window, each ending
with its answer on the host."""
import numpy as np


def read(ctx):
    lat = ctx.latencies("read")
    return float(np.percentile(lat, 95)) * 1e3 if lat.size else None
