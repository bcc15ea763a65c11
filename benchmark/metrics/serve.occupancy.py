"""Requests per padded batch over the window (``InferenceEngine.counters``)."""


def read(run):
    c = run.outcome.counters
    return c["requests"] / c["batches"] if c.get("batches") else None
