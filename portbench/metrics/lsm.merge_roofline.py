"""The engine's merges against the HBM roofline: the bytes of the entries
its flushes and major compactions merge, each read once and written once
(12 bytes an entry, from the counts before and after), at 3.35 TB/s, over
all device time of the kernels and copies launched inside the flushes
(the compactions run inside them), whatever kernels do the work."""
from portbench.measure import bound_ms


def read(ctx):
    n_bytes = (ctx.span_bytes.get("lsm.flush", 0)
               + ctx.span_bytes.get("lsm.compaction", 0))
    spent = ctx.trace.get("in_label_s", {}).get("lsm.flush", 0.0)
    if not n_bytes or spent <= 0:
        return None
    return 100.0 * bound_ms(n_bytes) / 1e3 / spent
