"""Contrastive reference-feature losses and feature-space statistics
(counterpart of ``segtran_tpu/train/contrast.py``; reference
internal_util.py:77-194, tsne.py:118-158).

The bank holds per-class reference feature vectors (a ``--savefeat``
dump). In training, each class's pixel features are pulled toward the
same class's bank (one-way average Hausdorff, top-3) and, with
``--negcontrast``, pushed from a random other class's bank. As in JAX,
the distances from every pixel of the feature grid to the whole bank are
one [P, K*R] matrix and each class's statistic is a mask-weighted mean;
the reference subsamples a varying number of class pixels instead, which
gives the same numbers whenever it keeps them all.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.norm import global_sum
from ..ops.resize import resize_linear


def pearson(t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
    """Pearson correlation of two equal-shape tensors, flattened (reference
    internal_util.py:77-92); a norm under 1e-5 counts as 1."""
    a = t1.reshape(-1).float()
    b = t2.reshape(-1).float()
    az, bz = a - a.mean(), b - b.mean()
    n1, n2 = az.square().sum().sqrt(), bz.square().sum().sqrt()
    n1 = torch.where(n1 < 1e-5, torch.ones_like(n1), n1)
    n2 = torch.where(n2 < 1e-5, torch.ones_like(n2), n2)
    return (az * bz).sum() / (n1 * n2)


def lr_pearson(t1: torch.Tensor) -> torch.Tensor:
    """Pearson between the halves of the last dim (reference :94-97)."""
    half = t1.shape[-1] // 2
    return pearson(t1[..., :half], t1[..., half:2 * half])


def _cdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean distances [P, R] through one product; the square root is
    taken of at least 1e-12 (a zero distance would give an infinite
    gradient)."""
    sq = (a.square().sum(-1)[:, None] + b.square().sum(-1)[None, :]
          - 2.0 * a @ b.T)
    return sq.clamp(min=1e-12).sqrt()


def avg_hausdorff(a: torch.Tensor, b: torch.Tensor, topk: int = 1,
                  one_way: bool = False,
                  exclude_id: bool = True) -> torch.Tensor:
    """Average Hausdorff distance of point sets a [P, C] and b [R, C]
    (reference internal_util.py:139-152): the mean over a's points of the
    mean of their ``topk`` smallest distances to b, averaged with b's
    mean nearest distance unless ``one_way``; ``exclude_id`` counts
    distances of 1e-6 and less as 1e6 (a compared with itself)."""
    d = _cdist(a.float(), b.float())
    if exclude_id:
        d = torch.where(d <= 1e-6, torch.full_like(d, 1e6), d)
    avg_a = torch.topk(d, topk, dim=-1, largest=False).values.mean()
    if one_way:
        return avg_a
    return (avg_a + d.min(0).values.mean()) / 2


def avg_hausdorff_np(a: np.ndarray, b: np.ndarray,
                     exclude_id: bool = True) -> float:
    """NumPy average Hausdorff (reference internal_util.py:128-137), for
    the checkpoint-feature analysis (reference tsne.py:145-158)."""
    d = np.sqrt(np.maximum(
        (a ** 2).sum(-1)[:, None] + (b ** 2).sum(-1)[None, :]
        - 2.0 * a.astype(np.float64) @ b.astype(np.float64).T, 0.0))
    if exclude_id:
        d[d == 0] = 1e6
    return float((d.min(axis=1).mean() + d.min(axis=0).mean()) / 2)


def load_reference_features(
        path: str, num_ref_features: int, num_classes: int,
        selected_ref_classes: Optional[Sequence[int]] = None,
        seed: int = 0, topk: int = 3,
) -> Tuple[np.ndarray, np.ndarray]:
    """A per-pixel feature dump (an .npz with ``features``/``labels``, or
    the reference's torch dict of the same keys) bucketed by class
    (reference internal_util.py:99-125): a class with more than
    ``num_ref_features`` points keeps a seeded permutation's first ones,
    one outside ``selected_ref_classes`` (when given) or with fewer than
    ``topk`` points none. Returns (bank [K, R, C] float32, valid [K, R])."""
    if path.endswith((".npz", ".npy")):
        data = np.load(path)
        features = np.asarray(data["features"], np.float32)
        labels = np.asarray(data["labels"])
    else:
        d = torch.load(path, map_location="cpu", weights_only=True)
        features = d["features"].numpy().astype(np.float32)
        labels = d["labels"].numpy()
    rng = np.random.RandomState(seed)
    r = num_ref_features
    bank = np.zeros((num_classes, r, features.shape[1]), np.float32)
    valid = np.zeros((num_classes, r), bool)
    for i in range(num_classes):
        if selected_ref_classes and i not in selected_ref_classes:
            continue
        cls = features[labels == i]
        if len(cls) > r:
            cls = cls[rng.permutation(len(cls))[:r]]
        if len(cls) < topk:
            continue
        bank[i, :len(cls)] = cls
        valid[i, :len(cls)] = True
    return bank, valid


def calc_contrast_losses(
        features: torch.Tensor, mask: torch.Tensor, bank: torch.Tensor,
        bank_valid: torch.Tensor, class_weights: torch.Tensor,
        neg_offsets: Optional[torch.Tensor] = None,
        do_neg_contrast: bool = False, topk: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos, neg) contrastive losses (reference calc_contrast_losses,
    internal_util.py:154-194). features [B, h, w, C]; mask [B, H, W, K]
    n-hot, resized to the feature grid and thresholded at 0.5; bank,
    bank_valid from ``load_reference_features``; class_weights [K].

    pos: over the foreground classes with pixels and a bank, w_c times the
    mean over the class's pixels of the mean of their ``topk`` smallest
    distances to bank[c]. neg (``do_neg_contrast``): the same statistic
    against the bank of class (c + neg_offsets[c]) % K, at half weight;
    ``neg_offsets`` [K] in [1, K) (JAX draws them from its key each
    step; the caller draws them from a generator). The class means span
    the global batch within ``ops.norm.global_batch``."""
    k = bank.shape[0]
    b, h, w, c = features.shape
    m_small = resize_linear(mask.float(), (h, w))
    onehot = (m_small >= 0.5).reshape(-1, k)                  # [P, K]
    feats = features.reshape(-1, c).float()
    d = _cdist(feats, bank.reshape(-1, bank.shape[-1]))       # [P, K*R]
    d = d.reshape(-1, k, bank.shape[1])
    d = torch.where(bank_valid[None], d, torch.full_like(d, float("inf")))
    dpix = torch.topk(d.permute(1, 0, 2), topk, dim=-1,
                      largest=False).values.mean(-1)          # [K, P]
    cls_has_bank = bank_valid.any(-1)                         # [K]
    dpix = torch.where(cls_has_bank[:, None], dpix, torch.zeros_like(dpix))
    wpix = onehot.T.float()                                   # [K, P]
    # the pixel counts and distance sums of the global batch
    sums = global_sum(torch.cat([wpix @ dpix.T, wpix.sum(-1)[:, None]], 1))
    npix = sums[:, -1]
    # row: the pixels' class, column: the bank's class
    mean_d = sums[:, :-1] / npix.clamp(min=1.0)[:, None]
    fg = torch.arange(k, device=features.device) >= 1
    gate = (npix > 0) & cls_has_bank & fg
    cw = class_weights.float()
    pos = torch.where(gate, torch.diagonal(mean_d) * cw,
                      torch.zeros_like(cw)).sum()
    if not do_neg_contrast:
        return pos, torch.zeros((), device=features.device)
    if neg_offsets is None:
        raise ValueError("do_neg_contrast needs neg_offsets")
    neg_cls = (torch.arange(k, device=features.device) + neg_offsets) % k
    neg_d = mean_d.gather(1, neg_cls[:, None])[:, 0]
    neg_gate = (npix > 0) & fg & cls_has_bank[neg_cls]
    neg = torch.where(neg_gate, 0.5 * neg_d * cw, torch.zeros_like(cw)).sum()
    return pos, neg


def normalize_features_by_class(features: np.ndarray,
                                classes: np.ndarray) -> np.ndarray:
    """A parameter-free LayerNorm over the channels of each class's
    features (reference tsne.py:118-139, ``--featnorm``)."""
    out = features.astype(np.float32).copy()
    for i in np.unique(classes):
        sel = classes == i
        f = out[sel]
        mu = f.mean(-1, keepdims=True)
        var = f.var(-1, keepdims=True)
        out[sel] = (f - mu) / np.sqrt(var + 1e-5)
    return out
