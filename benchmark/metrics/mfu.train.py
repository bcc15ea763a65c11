"""Reference FLOPs of the steps in the window's untraced part
(forward and backward of the recipe batch) over that time and the H100's dense bf16 peak, in %."""
from benchmark.readers import mfu


def read(run):
    return mfu(run)
