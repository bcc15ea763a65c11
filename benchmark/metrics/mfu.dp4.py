"""Reference FLOPs of the global batch's steps in the window's untraced
part (forward and backward of 16 crops, ``work/flops.py``) over that time
and the dense bf16 peak of the cell's four H100s, in %."""
from benchmark.readers import mfu


def read(run):
    share = mfu(run)
    return share / run.workload["chips"] if share is not None else None
