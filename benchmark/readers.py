"""Helpers the per-layer metric readers share (``metrics/<name>.py``).
A reader returns None where its run gives it nothing to read; it never
returns 0 for a share of a roofline or of a peak."""
from __future__ import annotations

import statistics

from benchmark.work import epilogue, flash, peaks

KERNELS = {"epilogue": ("mid_pool_kernel",),
           "flash_fwd": ("fwd_kernel", "fwd_merge_kernel")}
WORK = {"epilogue": lambda s: epilogue.work(*s),
        "flash_fwd": lambda s: flash.work(*s)}


def window_spans(run, name):
    """Durations (s) of the spans ``name`` inside the window's untraced
    part (a traced run profiles only its last seconds)."""
    c = run.outcome.counters
    t0, t1 = c.get("window_t0_ns", 0), c.get("window_t1_ns", float("inf"))
    return [(s.t1 - s.t0) / 1e9 for s in run.spans.items
            if s.name == name and s.t0 >= t0 and s.t1 <= t1]


def mean_ms(values):
    return statistics.fmean(values) * 1e3 if values else None


def roofline(run, kernel: str):
    """The traced calls' least time (``work``, at the shapes the cell
    lists per item) over their traced device time, in %. The driver's
    count of the slice's launches (``traced_launches``) has to match the
    items' shapes: a slice that opens inside an item (a serving batch
    already running) may hold up to that item's later launches besides,
    and any other difference is a launch the shapes do not account for."""
    trace, n = run.trace, run.outcome.counters.get("traced_items", 0)
    shapes = run.workload.get("kernels_per_item", {}).get(kernel)
    if trace is None or not n or not shapes:
        return None
    want = run.outcome.counters.get("traced_launches", {}).get(kernel)
    if want is not None and not 0 <= want - n * len(shapes) < len(shapes):
        return None
    spent = trace.kernel_seconds(*KERNELS[kernel])
    if spent <= 0:
        return None
    bound = n * sum(peaks.bound_seconds(*WORK[kernel](s)) for s in shapes)
    return 100.0 * bound / spent


def idle(run):
    if run.trace is None or not run.trace.ops or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def mfu(run):
    """Reference FLOPs of the work the window's untraced part completed
    (``mfu_items`` in ``mfu_seconds``) over that time and the bf16 dense
    peak, in %."""
    from benchmark.work import flops
    c = run.outcome.counters
    items, seconds = c.get("mfu_items"), c.get("mfu_seconds")
    if not items or not seconds or seconds <= 0:
        return None
    per = flops.per_item(run.config, run.workload, c.get("state_shapes"))
    if not per:
        return None
    return 100.0 * items * per / (seconds * peaks.FLOPS["bf16"])
