"""Reference FLOPs of the volumes in the window's untraced part (one
whole-volume forward each) over that time and the H100's dense bf16 peak, in %."""
from benchmark.readers import mfu


def read(run):
    return mfu(run)
