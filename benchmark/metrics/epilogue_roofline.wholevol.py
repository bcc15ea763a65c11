"""The expansion epilogue's share of its roofline: the least time of the
traced calls (``work/epilogue.py`` at the cell's shapes) over the device
time of ``mid_pool_kernel`` in the traced slice, in %."""
from benchmark.readers import roofline


def read(run):
    return roofline(run, "epilogue")
