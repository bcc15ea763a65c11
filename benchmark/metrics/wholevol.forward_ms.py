"""Mean time of the model forward inside ``evaluate_volume``
(synchronised), over the window's volumes."""
from benchmark.readers import mean_ms, window_spans


def read(run):
    return mean_ms(window_spans(run, "wholevol.forward"))
