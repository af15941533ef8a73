"""Mean wall time of the index layer's calls in the window, ms (layer: index)."""

from perfbench.readers import index_ms


def read(ctx):
    return index_ms(ctx)
