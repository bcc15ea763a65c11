"""Mean time of BertAdam's step (synchronised on both sides), over the
window's steps."""
from benchmark.readers import mean_ms, window_spans


def read(run):
    return mean_ms(window_spans(run, "train.optimizer"))
