"""Reference FLOPs of the 2.5D steps in the window's untraced part
(``work/flops25d.py``: forward and backward of the recipe batch) over
that time and the H100's dense bf16 peak, in %."""
from benchmark.work import flops25d, peaks


def read(run):
    c = run.outcome.counters
    items, seconds = c.get("mfu_items"), c.get("mfu_seconds")
    if not items or not seconds or seconds <= 0:
        return None
    per = flops25d.per_item(run.config, run.workload, c.get("state_shapes"))
    if not per:
        return None
    return 100.0 * items * per / (seconds * peaks.FLOPS["bf16"])
