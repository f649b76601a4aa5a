"""K1's share of its roofline in the serving window (``common.k1_roofline``)."""

from benchmark.metrics.common import k1_roofline


def read(run):
    return k1_roofline(run)
