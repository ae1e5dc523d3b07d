"""Share of the put wall that ``EdgeSchema.put_triple`` spends outside the
pair's put: its second lookup of every key and the degree update."""


def read(ctx):
    wall = ctx.latencies("put").sum()
    if not wall or "pair.put" not in ctx.spans:
        return None
    return 100.0 * (wall - ctx.spans["pair.put"]) / wall
