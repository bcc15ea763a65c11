"""Auxiliary training losses (counterpart of ``segtran_tpu/train/da.py``).
This slice has the 3-D attention-consistency loss (reference
train3d.py:426-449); the 2-D and domain-adaptation losses come with the DA
slice.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from ..ops.losses import weighted_bce_with_logits
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
