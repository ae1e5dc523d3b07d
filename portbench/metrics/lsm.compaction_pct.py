"""Share of the put wall in the engine's flushes, the major compactions
they start included: the sum of the port's ``db_op_latency_s{op=flush}``
histogram over the window (a compaction runs inside a flush, so its own
histogram is not added)."""


def read(ctx):
    wall = ctx.latencies("put").sum()
    spent = ctx.program_sum("db_op_latency_s", op="flush")
    return 100.0 * spent / wall if wall and spent > 0 else None
