"""The features a forward kept, under the JAX package's ``intermediates``
paths and in the order JAX sows them.

JAX's models sow into flax's ``intermediates`` collection; the port's keep
the same tensors on their modules, each the tensor the forward already
holds (no copy), and only when asked:

* ``in_fpn_feat``: Segtran2d [B, h2, w2, C], Segtran25d [B, h2, w2, d3, C]
  and Segtran3d [B, d2, h2, w2, C], with ``model.keep_features``;
* ``pre_outc_feat``: the U-Net's features before ``outc``, with
  ``model.keep_features``;
* ``voxel_fusion/translayers_{i}/[in_ator_trans/|ator_out_trans/]attn_diag``
  and ``.../attention_scores`` (mince: ``attention_scores_{s}``): kept by
  the attention modules under ``--attndiag`` and ``--attnconsist``;
* ``voxel_fusion/layer_{i}_vfeat`` [B, N, C]: each translayer's output,
  kept by Segtran2d's encoder with ``keep_features`` unless ``cfg.remat``
  (JAX's ``keep_layer_outputs=not cfg.remat``).

``kept_features`` reads them after a forward; ``drop_kept_features``
releases them.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch
from torch import nn

_TOP = ("in_fpn_feat", "pre_outc_feat")


def _attention_records(layer: nn.Module) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path under the translayer, tensor) of what one translayer's
    attentions kept, in JAX's sow order."""
    subs = ([("in_ator_trans/", layer.in_ator_trans),
             ("ator_out_trans/", layer.ator_out_trans)]
            if hasattr(layer, "in_ator_trans") else [("", layer)])
    for prefix, m in subs:
        if getattr(m, "attn_diag", None) is not None:
            yield prefix + "attn_diag", m.attn_diag
        per_scale = getattr(m, "attention_scores_per_scale", None)
        if per_scale is not None:
            for si, s in enumerate(per_scale):
                yield f"{prefix}attention_scores_{si}", s
        elif getattr(m, "attention_scores", None) is not None:
            yield prefix + "attention_scores", m.attention_scores


def kept_features(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{JAX intermediates path: tensor} of the last forward, in JAX's order
    (the model's own features, then per translayer its attentions' records
    and its output)."""
    out = {name: getattr(model, name) for name in _TOP
           if getattr(model, name, None) is not None}
    enc = getattr(model, "voxel_fusion", None)
    if enc is None:
        return out
    layer_outputs = getattr(enc, "layer_outputs", None) or ()
    for i, layer in enumerate(enc.translayers):
        for path, t in _attention_records(layer):
            out[f"voxel_fusion/translayers_{i}/{path}"] = t
        if i < len(layer_outputs):
            out[f"voxel_fusion/layer_{i}_vfeat"] = layer_outputs[i]
    return out


def drop_kept_features(model: nn.Module) -> None:
    """Release the model's and its encoder's kept features (the
    attentions' records are theirs: they go with the next forward)."""
    for name in _TOP:
        if getattr(model, name, None) is not None:
            setattr(model, name, None)
    enc = getattr(model, "voxel_fusion", None)
    if enc is not None and getattr(enc, "layer_outputs", None) is not None:
        enc.layer_outputs = None
