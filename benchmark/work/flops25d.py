"""Reference FLOPs of one Segtran 2.5D train step, counted as
``flops.per_item`` counts the other cells': ``FlopCounterMode`` over the
plain reference (``reference/segtran25d.py``, its forward, loss and
backward) on the meta device, so the count is the model's and not the
route's. The cell's ``flops`` entry gives the input shape of one step.

The weight gradient of a grouped convolution (the EfficientNet's
depthwise ones) is counted as its forward's products, the work it needs:
``FlopCounterMode``'s own formula counts it as if the convolution were
dense, once per group too many.
"""
from __future__ import annotations

import torch
from torch.utils import flop_counter as fc
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import segtran25d as r25
from benchmark.reference import train3d as ref


def conv_backward(grad_out_shape, x_shape, w_shape, _bias, _stride,
                  _padding, _dilation, transposed, _output_padding, _groups,
                  output_mask, out_shape, **kwargs) -> int:
    """The input gradient as a transposed convolution (``FlopCounterMode``'s
    count), the weight gradient as the forward's products."""
    flops = 0
    if output_mask[0]:
        flops += fc.conv_flop_count(grad_out_shape, w_shape,
                                    fc.get_shape(out_shape[0]),
                                    not transposed)
    if output_mask[1]:
        flops += fc.conv_flop_count(x_shape, w_shape, grad_out_shape,
                                    transposed)
    return flops


def per_item(config, workload, shapes):
    spec = workload.get("flops")
    if not spec or not shapes:
        return None
    m = config["model"]
    with torch.device("meta"):
        sd = {k: torch.empty(tuple(s), requires_grad=not k.endswith(
            ("running_mean", "running_var", "num_batches_tracked")))
              for k, s in shapes.items()}
        x = torch.empty(tuple(spec["input"]))
    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: conv_backward})
    with counter:
        logits = r25.segtran25d(x, sd, m)
        mask = torch.empty(logits.shape, device="meta")
        loss = ref.loss_fn(logits, mask, m["bce_weight"], 0.5)
        leaves = [v for v in sd.values() if v.requires_grad]
        torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(counter.get_total_flops())
