"""Device ms per step in NCCL kernels (all-reduces of the BatchNorm
statistics, their gradients, the gradients and the metrics) in rank 0's
traced slice, over the steps of the slice; None where it holds none."""


def read(run):
    n = run.outcome.counters.get("traced_items", 0)
    if run.trace is None or not n:
        return None
    spent = run.trace.kernel_seconds("nccl", "Nccl")
    return spent / n * 1e3 if spent > 0 else None
