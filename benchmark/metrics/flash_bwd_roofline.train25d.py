"""The flash cross-attention backward's share of its roofline: the least
time of the traced backwards (``work/flash_bwd.py`` at the cell's
``flash_bwd`` shapes, once per step) over the device time of
``dkdv_kernel``, ``dq_kernel`` and ``dq_sum_kernel`` in the traced slice,
in %. None where the slice's launches differ from its steps' shapes."""
from benchmark.work import flash_bwd, peaks

KERNELS = ("dkdv_kernel", "dq_kernel", "dq_sum_kernel")


def read(run):
    trace, n = run.trace, run.outcome.counters.get("traced_items", 0)
    shapes = run.workload.get("kernels_per_item", {}).get("flash_bwd")
    if trace is None or not n or not shapes:
        return None
    want = run.outcome.counters.get("traced_launches", {}).get("flash_bwd")
    if want is not None and want != n * len(shapes):
        return None
    spent = trace.kernel_seconds(*KERNELS)
    if spent <= 0:
        return None
    bound = n * sum(peaks.bound_seconds(*flash_bwd.work(*s)) for s in shapes)
    return 100.0 * bound / spent
