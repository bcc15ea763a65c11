"""The recipe's train step over any forward: ``train3d.Trainer``'s step
(the augmentation, the forward in training mode, the loss, the gradients,
the global-norm clip and BertAdam over the recipe's parameter groups) with
the forward given, and a hook between the gradients and the clip where a
data-parallel step averages its ranks' gradients. Float32; nothing of the
program is imported.
"""
from __future__ import annotations

import torch

from . import train3d as ref
from .nets import FP32, Prec


class Trainer(ref.Trainer):
    """``train3d.Trainer`` with ``forward(image, sd, cfg, p, step) ->
    logits`` in place of ``segtran3d``, and ``reduce(grads, loss) ->
    (grads, loss)`` applied to the gradients {name: tensor} and the loss
    before the clip (the identity unless given)."""

    def __init__(self, params, buffers, cfg, train, forward,
                 p: Prec = FP32, reduce=None):
        super().__init__(params, buffers, cfg, train, p)
        self.forward = forward
        self.reduce = reduce

    def step(self, image, label, draws):
        hp = self.hp
        img, msk = ref.augment(image, label, draws, hp["input_size"])
        sd = dict(self.buffers, **self.params)
        logits = self.forward(img, sd, self.cfg, self.p, self.step_count)
        if self.first_logits is None:
            self.first_logits = logits.detach().float().cpu()
        loss = ref.loss_fn(logits, msk, self.cfg["bce_weight"],
                           hp["dice_weight"])
        grads = torch.autograd.grad(loss, list(self.params.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(self.params.items(), grads)}
        loss = loss.detach()
        if self.reduce is not None:
            grads, loss = self.reduce(grads, loss)
        self.update(grads)
        return float(loss)

    @torch.no_grad()
    def update(self, grads):
        """The global clip and BertAdam, as ``train3d.Trainer.step``."""
        hp = self.hp
        norm = torch.sqrt(sum((g ** 2).sum() for g in grads.values()))
        if float(norm) >= hp["grad_clip"]:
            grads = {k: g / norm * hp["grad_clip"] for k, g in grads.items()}
        warm = min(hp["lr_warmup_steps"], hp["maxiter"] // 2) / hp["maxiter"]
        clipped = {}
        for k, prm in self.params.items():
            grp = ref.param_group(k)
            lr = hp["lr"] * (100 if grp == "high_lr" else 1)
            wd = {"normal": hp["decay"], "low_decay": hp["decay"] * 0.1,
                  "high_lr": 0.0}[grp]
            g = grads[k]
            g = g * torch.clamp(0.05 / (torch.linalg.vector_norm(g) + 1e-6),
                                max=1.0)
            clipped[k] = g
            self.m[k].mul_(0.9).add_(g * 0.1)
            self.v[k].mul_(0.999).add_(g * g * 0.001)
            upd = self.m[k] / (self.v[k].sqrt() + 1e-6)
            if wd > 0:
                upd = upd + wd * prm
            prm.add_(-ref.lr_at(self.step_count, lr, warm, hp["maxiter"])
                     * upd)
        if self.first_grads is None:
            self.first_grads = clipped
        self.step_count += 1
