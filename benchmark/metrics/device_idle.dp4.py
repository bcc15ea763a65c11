"""The share of rank 0's traced slice in which no operation ran on its
card, in %."""
from benchmark.readers import idle


def read(run):
    return idle(run)
