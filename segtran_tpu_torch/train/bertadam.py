"""BertAdam as a ``torch.optim.Optimizer`` (counterpart of
``segtran_tpu/train/bertadam.py``; reference code/optimization.py:40-164):

* each parameter's gradient clipped to norm ``max_grad_norm`` first;
* Adam moments with no bias correction, eps 1e-6;
* decoupled weight decay added to the update, not to the gradient;
* the warmup-linear schedule, read at the step count BEFORE its increment:
  the first update has lr 0, as in the reference, and step 2 is the first
  that moves the parameters.

Per-group hyperparameters come from the param groups
(``train/trainer.build_optimizer``).
"""
from __future__ import annotations

import torch


def warmup_linear_schedule(base_lr: float, warmup_ratio: float,
                           t_total: int):
    """lr(step), reference optimization.py:25-31 with x = step / t_total:
    lr * x / warmup during warmup, then lr * max((x - 1) / (warmup - 1), 0)."""
    def schedule(step: int) -> float:
        x = step / t_total
        if x < warmup_ratio:
            return base_lr * (x / warmup_ratio if warmup_ratio > 0 else 1.0)
        return base_lr * max((x - 1.0) / (warmup_ratio - 1.0), 0.0)
    return schedule


class BertAdam(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 2e-4, warmup: float = -1.0,
                 t_total: int = -1, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-6, weight_decay: float = 0.05,
                 max_grad_norm: float = 0.05):
        defaults = dict(lr=lr, warmup=warmup, t_total=t_total, b1=b1, b2=b2,
                        eps=eps, weight_decay=weight_decay,
                        max_grad_norm=max_grad_norm)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr_t = group["lr"]
            if group["t_total"] > 0:
                lr_t = warmup_linear_schedule(lr_t, group["warmup"],
                                              group["t_total"])(
                                                  group.get("step", 0))
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            wd, max_norm = group["weight_decay"], group["max_grad_norm"]
            for p in group["params"]:
                # a parameter the loss did not reach has a zero gradient,
                # and still decays (as in JAX)
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                st = self.state[p]
                if not st:
                    st["m"] = torch.zeros_like(p)
                    st["v"] = torch.zeros_like(p)
                if max_norm > 0:
                    norm = torch.linalg.vector_norm(g)
                    g = g * torch.clamp(max_norm / (norm + 1e-6), max=1.0)
                m, v = st["m"], st["v"]
                m.mul_(b1).add_(g * (1 - b1))
                v.mul_(b2).add_((g * g) * (1 - b2))
                upd = m / (v.sqrt() + eps)
                if wd > 0:
                    upd = upd + wd * p
                p.add_(-lr_t * upd)
            group["step"] = group.get("step", 0) + 1
