"""The flash cross-attention forward's share of its roofline: the least
time of the traced calls (``work/flash.py`` at the cell's shapes) over
the device time of ``fwd_kernel`` and ``fwd_merge_kernel`` in the traced
slice, in %."""
from benchmark.readers import roofline


def read(run):
    return roofline(run, "flash_fwd")
