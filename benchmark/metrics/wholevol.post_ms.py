"""Mean time of ``evaluate_volume`` less its forward: the upload, the
consistency fix, the hard map, the ground truth and the Dice."""
from benchmark.readers import mean_ms, window_spans


def read(run):
    vol = window_spans(run, "wholevol.volume")
    fwd = window_spans(run, "wholevol.forward")
    if not vol or len(vol) != len(fwd):
        return None
    return mean_ms([v - f for v, f in zip(vol, fwd)])
