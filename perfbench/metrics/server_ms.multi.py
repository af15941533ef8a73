"""Mean server time of POST /v1/query in the window, ms (layer: server)."""

from perfbench.readers import server_ms


def read(ctx):
    return server_ms(ctx)
