"""Percent of the traced training window in which no operation ran on the device."""

from benchmark.metrics.common import idle_share


def read(run):
    return idle_share(run)
