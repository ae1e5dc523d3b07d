"""Share of the put wall in the write-ahead log's appends: the sum of the
port's ``wal_latency_s{op=append}`` histogram over the window."""


def read(ctx):
    wall = ctx.latencies("put").sum()
    spent = ctx.program_sum("wal_latency_s", op="append")
    return 100.0 * spent / wall if wall and spent > 0 else None
