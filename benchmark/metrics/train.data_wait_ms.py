"""Mean time the training loop waits for its next batch from the
DevicePrefetcher, over the window's steps."""
from benchmark.readers import mean_ms, window_spans


def read(run):
    return mean_ms(window_spans(run, "train.data_wait"))
