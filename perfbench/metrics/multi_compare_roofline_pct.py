"""The weighted multi-hash compare's least time over kernel time, % (layer: ops)."""

from perfbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "multi")
