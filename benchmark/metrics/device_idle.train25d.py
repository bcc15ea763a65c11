"""The share of the 2.5D cell's traced slice in which no operation ran on
the device, in %."""
from benchmark.readers import idle


def read(run):
    return idle(run)
