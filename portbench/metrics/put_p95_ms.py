"""95th percentile of a put's latency (host clock, each ending with the
card synchronised): where flushes and major compactions land."""
import numpy as np


def read(ctx):
    lat = ctx.latencies("put")
    return float(np.percentile(lat, 95)) * 1e3 if lat.size else None
