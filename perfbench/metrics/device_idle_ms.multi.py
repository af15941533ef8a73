"""Time with a request in flight and no operation on the card, per request, ms (layer: device)."""

from perfbench.readers import idle_ms


def read(ctx):
    return idle_ms(ctx)
