"""K1's share of its roofline in the training window, its forward and
rematerialised calls together (``common.k1_roofline``)."""

from benchmark.metrics.common import k1_roofline


def read(run):
    return k1_roofline(run)
