"""Auxiliary training losses (counterpart of ``segtran_tpu/train/da.py``):
the attention-consistency losses (2-D margin form, reference
train2d.py:668-723; 3-D BCE form, train3d.py:426-449), the attention
diagnostics, reconstruction (train2d.py:923-926, 1253-1257), domain
adversarial (RevGrad / ADDA, train2d.py:1259-1286) and vCDR estimation
(train2d.py:1288-1312).

The model keeps what these read on its modules during the forward
(attention scores, diagnostics, features): a caller that runs the model
twice in a step (the DA source pass) reads them after the pass they
belong to.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from ..ops.losses import calc_vcdr_batch, weighted_bce_with_logits
from ..ops.norm import global_sum
from ..ops.resize import resize_linear


def collect_attn_scores(model: nn.Module) -> List:
    """Per-layer attention scores of the last forward, mode-pooled (the
    encoder keeps them with ``use_attn_consist_loss``). Squeezed layers
    give (in_scores [B, 1, A, N], out_scores [B, 1, N, A]) pairs, plain
    layers one [B, 1, N, N]. The mean over modes stands in for the
    reference's learned 1x1 mode-pooling convs (segtran_shared.py:896-905),
    as in JAX."""
    fusion = getattr(model, "voxel_fusion", None)
    layers = []
    for layer in (fusion.translayers if fusion is not None else ()):
        if hasattr(layer, "in_ator_trans"):
            in_s = layer.in_ator_trans.attention_scores
            out_s = layer.ator_out_trans.attention_scores
            if in_s is not None and out_s is not None:
                layers.append((in_s.mean(1, keepdim=True),
                               out_s.mean(1, keepdim=True)))
        elif getattr(layer, "attention_scores", None) is not None:
            layers.append(layer.attention_scores.mean(1, keepdim=True))
    return layers


def collect_attn_diag(model: nn.Module) -> Optional[torch.Tensor]:
    """[max over calls, mean of the positive means, clamp count] of the
    attention diagnostics the last forward kept (``attn_diag`` of every
    non-fused attention with ``keep_attn_diag``), or None when none
    kept any (the flash path keeps none)."""
    rows = [m.attn_diag for m in model.modules()
            if getattr(m, "attn_diag", None) is not None]
    if not rows:
        return None
    stats = torch.stack(rows)                                # [calls, 3]
    return torch.stack([stats[:, 0].max(), stats[:, 1].mean(),
                        stats[:, 2].sum()])


def attention_consistency_loss(layers_attn_scores: Sequence,
                               mask: torch.Tensor,
                               feat_shape: Sequence[int],
                               only_first_layer: bool = False
                               ) -> torch.Tensor:
    """The 2-D trainer's margin form (reference train2d.py:668-723): per
    layer, the mean absolute deviation from the mean score over the
    inconsistent pixel pairs (below the mean where the masks overlap,
    above the mean minus 0.1 where they do not), with one count over the
    batch; averaged over the layers and capped at 1 by a detached
    denominator. mask [B, H, W, C] n-hot; ``feat_shape`` (h2, w2). The
    count and the sums span the global batch within
    ``ops.norm.global_batch``."""
    resized = resize_linear(mask.float(), feat_shape)
    b, c = resized.shape[0], resized.shape[-1]
    flat = resized.reshape(b, -1, c)                          # [B, N, C]
    consistency = torch.einsum("bnc,bmc->bnm", flat, flat) > 0.0
    n_layers = 1 if only_first_layer else len(layers_attn_scores)
    total = 0.0
    for scores in layers_attn_scores[:n_layers]:
        if isinstance(scores, (tuple, list)):
            in_s, out_s = scores
            scores = torch.matmul(out_s, in_s)[:, 0]
        else:
            scores = scores[:, 0]
        mean_score = scores.mean((1, 2), keepdim=True)
        below = scores < mean_score
        above = scores > (mean_score - 0.1)
        inconsistent = (below & consistency) | (above & ~consistency)
        dev = (scores - mean_score).abs()
        sums = global_sum(torch.stack([(dev * inconsistent).sum(),
                                       inconsistent.sum().to(dev.dtype)]))
        total = total + sums[0] / (sums[1] + 1e-6)
    loss = total / n_layers
    return torch.where(loss > 1.0, loss / loss.detach().clamp(min=1.0), loss)


def attention_consistency_loss_3d(layers_attn_scores: Sequence,
                                  mask: torch.Tensor,
                                  feat_shape: Sequence[int],
                                  only_first_layer: bool = True,
                                  depth_first: bool = True) -> torch.Tensor:
    """BCE-with-logits between the attention scores and the binary
    mask-consistency matrix (reference train3d.py:426-449; the 2-D
    trainer's margin form differs). mask [B, H, W, D, C] n-hot;
    ``feat_shape`` is the token grid in raster order: (D2, H2, W2) for
    Segtran3d (``depth_first``), (H2, W2, D3) for Segtran25d."""
    m = mask.permute(0, 3, 1, 2, 4) if depth_first else mask
    resized = resize_linear(m.float(), feat_shape)
    b, c = resized.shape[0], resized.shape[-1]
    flat = resized.reshape(b, -1, c)                      # [B, N, C]
    consistency = torch.einsum("bnc,bmc->bnm", flat, flat).clamp(0.0, 1.0)
    n_layers = 1 if only_first_layer else len(layers_attn_scores)
    total = 0.0
    for scores in layers_attn_scores[:n_layers]:
        if isinstance(scores, (tuple, list)):
            in_s, out_s = scores
            scores = torch.matmul(out_s, in_s)            # [B, 1, N, N]
        total = total + weighted_bce_with_logits(scores[:, 0], consistency)
    return total / n_layers


def recon_loss(recon_head: Callable, feature_map: torch.Tensor,
               image: torch.Tensor) -> torch.Tensor:
    """MSE between the image and the reconstruction of the last feature
    map, resized to the image (reference train2d.py:1253-1257)."""
    reconed = recon_head(feature_map).float()
    if reconed.shape[1:3] != image.shape[1:3]:
        reconed = resize_linear(reconed, tuple(image.shape[1:3]))
    return torch.mean((reconed - image.float()) ** 2)


def domain_adversarial_loss(disc_apply: Callable, source_feat: torch.Tensor,
                            target_feat: torch.Tensor) -> torch.Tensor:
    """Discriminator BCE with source 0 / target 1 labels (reference
    train2d.py:1262-1277); through a gradient-reversal discriminator it
    trains the discriminator and reverses into the features."""
    mix = torch.cat([source_feat, target_feat], dim=0)
    labels = torch.cat([
        torch.zeros(source_feat.shape[0], 1, device=mix.device),
        torch.ones(target_feat.shape[0], 1, device=mix.device)])
    return weighted_bce_with_logits(disc_apply(mix), labels)


def vcdr_estimation_losses(estimate: Callable, probs: torch.Tensor,
                           gt_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The learned vCDR losses (reference train2d.py:1288-1312).
    ``estimate``: [B, H, W, C] probs -> [B] sigmoided vCDR estimates. The
    estimator regresses the hard vCDR of the prediction from detached
    probs (its gradient only), and on live probs the ground truth's
    (gradients into both)."""
    estim_loss = torch.mean((estimate(probs.detach())
                             - calc_vcdr_batch(probs)).abs())
    net_loss = torch.mean((estimate(probs) - calc_vcdr_batch(gt_mask)).abs())
    return {"vcdr_estim_loss": estim_loss, "vcdr_net_loss": net_loss}
