"""Share of the put wall spent in the connector's key encoding
(``DBserver.encode_keys``: the string dictionary), harness span."""


def read(ctx):
    wall = ctx.latencies("put").sum()
    if not wall or "connector.encode" not in ctx.spans:
        return None
    return 100.0 * ctx.spans["connector.encode"] / wall
