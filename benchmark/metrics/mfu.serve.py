"""Reference FLOPs of the frames answered in the window's untraced
part (not of padded slots) over that time and the H100's dense bf16 peak, in %."""
from benchmark.readers import mfu


def read(run):
    return mfu(run)
