"""The training step (counterpart of ``segtran_tpu/train/trainer.py``;
reference train2d.py:1134-1337):

* parameter groups by name (reference train2d.py:515-553): ``alphas`` at
  100x lr without decay, ``backbone`` at a tenth of the decay, the rest
  normal; each group a BertAdam group;
* an optional global-norm clip of all gradients before the groups
  (optax ``clip_by_global_norm``: unchanged below the norm, else
  ``g / norm * max_norm``);
* gradient accumulation over microbatches: gradients summed and divided by
  their count before the one update, BatchNorm statistics per microbatch
  and the running statistics updated microbatch after microbatch;
* within ``ops.norm.global_batch`` (a data-parallel step,
  ``parallel/mesh.shard_train_step``): the gradients averaged over the
  data group before the clip, and the metrics the global batch's;
* the 2-D loss (reference train2d.py:1228-1318): (1 - dice_w) BCE with
  pos-weights + dice_w times the class-weighted Dice of classes 1..C-1.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence

import torch
from torch import nn

from ..ops.losses import dice_loss_indiv, weighted_bce_with_logits
from ..ops.norm import (average_gradients, batch_group, global_batch,
                        global_mean)
from ..ops.resize import resize_linear
from .bertadam import BertAdam


def label_params(model: nn.Module) -> Dict[str, str]:
    """{parameter name: 'high_lr' | 'low_decay' | 'normal'}."""
    labels = {}
    for name, _ in model.named_parameters():
        if "alphas" in name:
            labels[name] = "high_lr"
        elif "backbone" in name:
            labels[name] = "low_decay"
        else:
            labels[name] = "normal"
    return labels


def build_optimizer(model: nn.Module, lr: float = 2e-4, decay: float = 1e-4,
                    t_total: int = 10000, warmup_ratio: float = 0.05
                    ) -> BertAdam:
    """BertAdam over the reference's three parameter groups."""
    hyper = {"normal": dict(lr=lr, weight_decay=decay),
             "low_decay": dict(lr=lr, weight_decay=decay * 0.1),
             "high_lr": dict(lr=lr * 100, weight_decay=0.0)}
    labels = label_params(model)
    groups = []
    for label, kw in hyper.items():
        params = [p for n, p in model.named_parameters()
                  if labels[n] == label]
        if params:
            groups.append(dict(params=params, label=label, **kw))
    return BertAdam(groups, lr=lr, warmup=warmup_ratio, t_total=t_total)


def make_class_weights(num_classes: int, focus_class: int = -1
                       ) -> torch.Tensor:
    """Ones, background 0, ``focus_class`` 2 (with more than two classes),
    normalised to sum 1 (reference train2d.py:1123-1127)."""
    w = torch.ones(num_classes)
    w[0] = 0.0
    if focus_class != -1 and num_classes > 2:
        w[focus_class] = 2.0
    return w / w.sum()


def make_loss_fn(num_classes: int, bce_weight: Sequence[float],
                 dice_w: float = 0.5, focus_class: int = -1) -> Callable:
    """(logits [B, H, W, C], mask [B, H, W, C]) -> (loss, metrics): logits
    resized bilinearly to the mask's size where they differ; the BCE
    pos-weights rescaled to sum to C - 1 (reference train2d.py:814)."""
    class_weights = make_class_weights(num_classes, focus_class).tolist()
    bce = torch.tensor(bce_weight, dtype=torch.float32)
    pos_weight = (bce * (num_classes - 1) / bce.sum()).reshape(
        1, 1, 1, num_classes)

    def loss_fn(logits, mask):
        if logits.shape[1:3] != mask.shape[1:3]:
            logits = resize_linear(logits, tuple(mask.shape[1:3]))
        probs = torch.sigmoid(logits.float())
        ce = weighted_bce_with_logits(logits, mask,
                                      pos_weight.to(logits.device))
        dice_total = 0.0
        metrics = {}
        for cls in range(1, num_classes):
            d = dice_loss_indiv(probs[..., cls], mask[..., cls])
            metrics[f"dice_loss_cls{cls}"] = d
            dice_total = dice_total + d * class_weights[cls]
        loss = (1.0 - dice_w) * ce + dice_w * dice_total
        return loss, {"loss": loss, "ce_loss": ce, "dice_loss": dice_total,
                      **metrics}

    return loss_fn


def resolve_remat_blocks(batch_size: int, grad_accum: int, n_devices: int,
                         tensor_parallel: int):
    """JAX train2d's rule for ``remat_blocks`` (kept so that both packages
    take the same path; its threshold was measured on the TPU): on below a
    per-device microbatch of 12. Returns (remat_blocks, microbatch)."""
    dp = max(n_devices // max(tensor_parallel, 1), 1)
    mb = max(batch_size // max(grad_accum, 1) // dp, 1)
    return mb < 12, mb


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[torch.Tensor],
                         max_norm: float) -> None:
    """optax ``clip_by_global_norm`` on the .grad of ``params`` in place,
    with no host synchronisation."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    loss_fn: Callable, grad_accum: int = 1,
                    grad_clip: float = 0.0,
                    aux_loss_fn: Optional[Callable] = None) -> Callable:
    """train_step(batch {'image', 'mask'}) -> metrics {name: 0-d tensor},
    one optimizer update (none with ``optimizer=None``, and no backward
    where no parameter takes a gradient: train2d's --tunebn);
    ``loss_fn(logits, mask) -> (loss, metrics)``.
    ``aux_loss_fn(model, mask) -> (extra loss, metrics)``, where given, is
    read after each forward (the model keeps what it needs, e.g. the
    attention scores) and its loss added before the backward (JAX
    train/trainer.py:113-160). The batch splits into ``grad_accum``
    microbatches along dim 0."""
    params = list(model.parameters())

    def train_step(batch):
        model.train()
        model.zero_grad(set_to_none=True)
        sums: Dict[str, torch.Tensor] = {}
        for image, mask in zip(batch["image"].chunk(grad_accum),
                               batch["mask"].chunk(grad_accum)):
            # a microbatch's draws (drop-connect, in the forward and a
            # recompute) are those of one global microbatch
            with global_batch(batch_group()):
                loss, metrics = loss_fn(model(image), mask)
                if aux_loss_fn is not None:
                    extra, extra_metrics = aux_loss_fn(model, mask)
                    loss = loss + extra
                    metrics = dict(metrics, **extra_metrics, loss=loss)
                if loss.requires_grad:
                    loss.backward()
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0) + v.detach()
        if grad_accum > 1:
            for p in params:
                if p.grad is not None:
                    p.grad.div_(grad_accum)
        average_gradients(params)
        if grad_clip and grad_clip > 0:
            clip_by_global_norm_(params, grad_clip)
        if optimizer is not None:
            optimizer.step()
        return global_metrics({k: v / grad_accum for k, v in sums.items()})

    return train_step


def global_metrics(metrics: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """The step's metrics averaged over the data group (one all-reduce):
    the global batch's, as JAX's sharded step returns them."""
    if batch_group() is None or not metrics:
        return metrics
    with torch.no_grad():
        vals = global_mean(torch.stack([torch.as_tensor(v).float()
                                        for v in metrics.values()]))
    return dict(zip(metrics, vals.unbind()))
