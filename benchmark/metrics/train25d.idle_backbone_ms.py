"""Device-idle ms per step of the traced slice under the 2.5D model's
backbone stage (``segtran25d.backbone``: the depth fold, the per-slice
EfficientNet and the 2-D input FPN, up to the depth-pooled volume), over
the steps whose forward starts in the slice."""
from benchmark.program_spans import idle_per_item_ms


def read(run):
    return idle_per_item_ms(run, ("segtran25d.backbone",),
                            per="trainer.forward")
