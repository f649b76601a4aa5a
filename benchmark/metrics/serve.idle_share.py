"""Percent of the traced serving window in which no operation ran on the device."""

from benchmark.metrics.common import idle_share


def read(run):
    return idle_share(run)
