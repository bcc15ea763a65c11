"""Mean host time of ``InferenceEngine.forward`` (one padded batch, from
the host batch to the host probabilities), over the window's forwards."""
from benchmark.readers import mean_ms, window_spans


def read(run):
    return mean_ms(window_spans(run, "serve.forward"))
