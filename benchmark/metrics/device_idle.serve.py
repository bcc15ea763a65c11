"""The share of the traced slice in which no operation ran on the
device, in %."""
from benchmark.readers import idle


def read(run):
    return idle(run)
