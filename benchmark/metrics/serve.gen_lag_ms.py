"""99th percentile of how late the load generator submitted each request
after its due time, in ms."""
from benchmark.harness import percentile


def read(run):
    lag = run.outcome.counters.get("gen_lag_s")
    return percentile(lag, 99) * 1e3 if lag else None
