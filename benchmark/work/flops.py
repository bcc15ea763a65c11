"""Reference FLOPs of one item of a cell (a served frame, a volume, a
train step), counted by ``FlopCounterMode`` over the plain reference on
the meta device, so the count is the model's and not the route's: the
same whichever kernels the program takes. The cell's ``flops`` entry
gives the pass (``forward`` or ``train``: forward and backward) and the
input shape of one item."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import nets
from benchmark.reference import train3d as ref


def per_item(config, workload, shapes):
    spec = workload.get("flops")
    if not spec or not shapes:
        return None
    m = config["model"]
    train = spec["pass"] == "train"
    with torch.device("meta"):
        sd = {k: torch.empty(tuple(s), requires_grad=train and
                             not k.endswith(("running_mean", "running_var")))
              for k, s in shapes.items()}
        x = torch.empty(tuple(spec["input"]))
    counter = FlopCounterMode(display=False)
    with counter:
        if m["kind"] == "segtran2d":
            nets.segtran2d(x, sd, m)
        elif train:
            logits = nets.segtran3d(x, sd, m, train=True)
            mask = torch.empty(logits.shape, device="meta")
            loss = ref.loss_fn(logits, mask, m["bce_weight"], 0.5)
            leaves = [v for v in sd.values() if v.requires_grad]
            torch.autograd.grad(loss, leaves, allow_unused=True)
        else:
            nets.segtran3d(x, sd, m)
    return float(counter.get_total_flops())
