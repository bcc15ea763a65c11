"""The plain reference of the BraTS recipe train step: the epoch order
and crops of the training set, the augmentation (quarter turns and flips
per sample, the BraTS region masks, the batch's centred zoom), the
forward of ``nets.segtran3d`` in training mode, (1 - w) weighted BCE +
w class-averaged Dice, the global-norm clip and BertAdam (per-tensor
clip, no bias correction, decoupled decay, warmup-linear read before the
step count moves) over the recipe's parameter groups. Float32 throughout;
nothing of the program is imported.
"""
from __future__ import annotations

import numpy as np
import torch

from .nets import FP32, Prec, resize, segtran3d


def epoch_order(n: int, epoch: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState((seed * 1_000_003 + epoch) % (2 ** 31))
    return rng.permutation(n)


def crop(volume, epoch: int, idx: int, seed: int, size):
    """The training crop of sample ``idx``: starts drawn from a generator
    keyed by (seed, epoch, idx), the label's 4 mapped to 3 first."""
    image, label = volume["image"], volume["label"]
    label = (label - (label == 4)).astype(label.dtype)
    rng = np.random.default_rng((seed, epoch, int(idx)))
    starts = [int(rng.integers(0, s - t + 1))
              for s, t in zip(image.shape[:3], size)]
    sl = tuple(slice(st, st + t) for st, t in zip(starts, size))
    return image[sl], label[sl]


def batches(volumes, batch_size: int, seed: int, size, count: int):
    """The first ``count`` batches as the training loop meets them:
    [{'image' [B, H, W, D, C], 'label' [B, H, W, D]}] (numpy)."""
    out, epoch = [], 0
    while len(out) < count:
        order = epoch_order(len(volumes), epoch, seed)
        for s in range(0, len(order) // batch_size * batch_size, batch_size):
            pairs = [crop(volumes[i], epoch, i, seed, size)
                     for i in order[s:s + batch_size]]
            out.append({"image": np.stack([p[0] for p in pairs]),
                        "label": np.stack([p[1] for p in pairs])})
            if len(out) == count:
                break
        epoch += 1
    return out


def brats_regions(label):
    """[..., 4] of (background, ET, WT, TC) from labels {0, 1, 2, 3}."""
    return torch.stack([label == 0, label == 3,
                        (label >= 1) & (label <= 3),
                        (label == 1) | (label == 3)], -1).float()


def _lerp(vol, axis, coords):
    n = vol.shape[axis]
    i0 = torch.floor(coords).long()
    i1 = torch.clamp(i0 + 1, max=n - 1)
    shape = [1] * vol.dim()
    shape[axis] = coords.shape[0]
    w = (coords - i0.float()).reshape(shape)
    return vol.index_select(axis, i0) * (1 - w) + vol.index_select(axis, i1) * w


def augment(image, label, draws, input_size):
    """image [B, H, W, D, C], label [B, H, W, D] on the device; draws
    {'rot_flip': (k, flip_h, flip_w) per sample, 'zoom': f}."""
    ks, fhs, fws = draws["rot_flip"]
    ims, labs = [], []
    for i in range(image.shape[0]):
        im = torch.rot90(image[i], int(ks[i]), (0, 1))
        lb = torch.rot90(label[i], int(ks[i]), (0, 1))
        if bool(fhs[i]):
            im, lb = im.flip(0), lb.flip(0)
        if bool(fws[i]):
            im, lb = im.flip(1), lb.flip(1)
        ims.append(im)
        labs.append(lb)
    image, mask = torch.stack(ims), brats_regions(torch.stack(labs))
    f = draws["zoom"]
    grids, valid = [], None
    for ax, n in enumerate(image.shape[1:4]):
        c = (torch.arange(n, dtype=torch.float32, device=image.device)
             - (n - 1) / 2.0) * f + (n - 1) / 2.0
        ok = (c >= -0.5) & (c <= n - 0.5)
        shape = [1, 1, 1]
        shape[ax] = n
        valid = ok.reshape(shape) if valid is None else valid & ok.reshape(shape)
        grids.append(torch.clamp(c, 0, n - 1))
    img = image
    for ax, g in enumerate(grids):
        img = _lerp(img, ax + 1, g)
    idx = [torch.round(g).long() for g in grids]
    msk = mask.index_select(1, idx[0]).index_select(2, idx[1]) \
        .index_select(3, idx[2])
    v = valid[None, ..., None].float()
    img, msk = img * v, msk * v
    if tuple(img.shape[1:4]) != tuple(input_size):
        img = resize(img.permute(0, 4, 1, 2, 3), input_size).permute(
            0, 2, 3, 4, 1)
    return img, msk


def loss_fn(logits, mask, bce_weight, dice_w):
    """(1 - dice_w) pos-weighted BCE + dice_w mean Dice of classes 1..C-1."""
    n = logits.shape[-1]
    w = torch.tensor(bce_weight, dtype=torch.float32, device=logits.device)
    pos_weight = w * (n - 1) / w.sum()
    log1p = torch.log1p(torch.exp(-logits.abs()))
    log_sig = torch.clamp(logits, max=0.0) - log1p
    log_not = -torch.clamp(logits, min=0.0) - log1p
    ce = (-(pos_weight * mask * log_sig + (1 - mask) * log_not)).mean()
    probs = torch.sigmoid(logits)
    b = logits.shape[0]
    dice = 0.0
    for c in range(1, n):
        s = probs[..., c].reshape(b, -1)
        g = mask[..., c].reshape(b, -1)
        d = 1 - (2 * (s * g).sum(1) + 1e-5) / ((s * s).sum(1)
                                              + (g * g).sum(1) + 1e-5)
        dice = dice + d.mean() / (n - 1)
    return (1 - dice_w) * ce + dice_w * dice


def param_group(name: str) -> str:
    if "alphas" in name:
        return "high_lr"
    return "low_decay" if "backbone" in name else "normal"


def lr_at(step: int, base: float, warmup: float, t_total: int) -> float:
    x = step / t_total
    if x < warmup:
        return base * (x / warmup if warmup > 0 else 1.0)
    return base * max((x - 1.0) / (warmup - 1.0), 0.0)


class Trainer:
    """The reference step over ``params`` {name: fp32 tensor} (the
    trainable leaves) and ``buffers`` (BatchNorm statistics, read by
    nothing in training). ``train`` gives the recipe's hyperparameters
    (the configuration's ``train`` section)."""

    def __init__(self, params, buffers, cfg, train, p: Prec = FP32):
        self.cfg, self.hp, self.p = cfg, train, p
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in params.items()}
        self.buffers = buffers
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.step_count = 0
        self.first_grads = None         # the per-tensor clipped gradients
        self.first_logits = None        # step 1's forward output (CPU)

    def step(self, image, label, draws):
        hp = self.hp
        img, msk = augment(image, label, draws, hp["input_size"])
        sd = dict(self.buffers, **self.params)
        logits = segtran3d(img, sd, self.cfg, self.p, train=True)
        if self.first_logits is None:
            self.first_logits = logits.detach().float().cpu()
        loss = loss_fn(logits, msk, self.cfg["bce_weight"], hp["dice_weight"])
        grads = torch.autograd.grad(loss, list(self.params.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(self.params.items(), grads)}
        with torch.no_grad():
            norm = torch.sqrt(sum((g ** 2).sum() for g in grads.values()))
            if float(norm) >= hp["grad_clip"]:
                grads = {k: g / norm * hp["grad_clip"]
                         for k, g in grads.items()}
            warm = min(hp["lr_warmup_steps"], hp["maxiter"] // 2) / hp["maxiter"]
            clipped = {}
            for k, prm in self.params.items():
                grp = param_group(k)
                lr = hp["lr"] * (100 if grp == "high_lr" else 1)
                wd = {"normal": hp["decay"], "low_decay": hp["decay"] * 0.1,
                      "high_lr": 0.0}[grp]
                g = grads[k]
                g = g * torch.clamp(0.05 / (torch.linalg.vector_norm(g)
                                            + 1e-6), max=1.0)
                clipped[k] = g
                self.m[k].mul_(0.9).add_(g * 0.1)
                self.v[k].mul_(0.999).add_(g * g * 0.001)
                upd = self.m[k] / (self.v[k].sqrt() + 1e-6)
                if wd > 0:
                    upd = upd + wd * prm
                prm.add_(-lr_at(self.step_count, lr, warm, hp["maxiter"])
                         * upd)
            if self.first_grads is None:
                self.first_grads = clipped
            self.step_count += 1
        return float(loss.detach())
