"""95th percentile of the Fig. 4 reads' latency (host clock, each ending
with its answer on the host); a per-layer metric where the card idles."""
import numpy as np


def read(ctx):
    lat = ctx.latencies("read")
    return float(np.percentile(lat, 95)) * 1e3 if lat.size else None
