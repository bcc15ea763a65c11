"""Polyformer: the squeezed-attention adapter for few-shot domain
adaptation (MICCAI'21). Counterpart of ``segtran_tpu/adapt/polyformer.py``
(reference code/networks/polyformer.py).

``PolyformerLayer``: 2x average-pool the host CNN's channels-last
features, an optional parameter-free LayerNorm, the attractor squeeze
(``in_ator_trans``: attractors <- tokens; ``ator_out_trans``: tokens <-
attractors; both aggregate-only ``CrossAttFeatTrans``, ``has_FFN=False``),
a bilinear upsample back and a residual add. ``tie_qk_scheme`` is
``shared`` for source training, ``loose`` for target adaptation (K apart
from Q, so that K alone can be fine-tuned). Its attention never takes the
flash path: the layer spec leaves ``use_fused_attention`` off, as JAX's
does.

``polyformer_param_labels`` chooses the parameters that --sourceopt /
--targetopt train (``allpoly|inator|k|q|v|h|allnet``, comma-combined;
``bn_opt_scheme='affine'`` also the BatchNorm affines).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch
from torch import nn

from ..nn.attention import CrossAttFeatTrans, TransLayerSpec
from ..ops.norm import LayerNorm
from ..ops.resize import avg_pool_nhwc, resize_linear


class PolyformerLayer(nn.Module):
    """[B, H, W, F] -> [B, H, W, F] (reference polyformer.py:8-55)."""

    def __init__(self, feat_dim: int, num_attractors: int = 256,
                 num_modes: int = 4, tie_qk_scheme: str = "loose",
                 qk_have_bias: bool = True, has_FFN: bool = False,
                 poly_do_layernorm: bool = False, attn_clip: float = 500.0,
                 dtype=torch.float32):
        super().__init__()
        spec = TransLayerSpec(
            in_feat_dim=feat_dim, feat_dim=feat_dim, num_modes=num_modes,
            qk_have_bias=qk_have_bias, v_has_bias=False,
            tie_qk_scheme=tie_qk_scheme, attn_clip=attn_clip,
            has_FFN=has_FFN, attention_probs_dropout_prob=0.0,
            hidden_dropout_prob=0.0, dtype=dtype)
        self.feat_dim, self.dtype = feat_dim, dtype
        self.attractors = nn.Parameter(torch.empty(1, num_attractors,
                                                   feat_dim))
        if poly_do_layernorm:
            self.infeat_norm_layer = LayerNorm(feat_dim, 1e-12, affine=False,
                                               dtype=dtype)
        self.in_ator_trans = CrossAttFeatTrans(spec)
        self.ator_out_trans = CrossAttFeatTrans(spec)

    def forward(self, in_feat: torch.Tensor) -> torch.Tensor:
        b = in_feat.shape[0]
        # full-resolution attention is needlessly slow (polyformer.py:36-38)
        half = avg_pool_nhwc(in_feat, (2, 2))
        vfeat = half
        if hasattr(self, "infeat_norm_layer"):
            vfeat = self.infeat_norm_layer(vfeat)
        h2, w2 = half.shape[1:3]
        vfeat = vfeat.reshape(b, h2 * w2, self.feat_dim)
        attractors = self.attractors.to(self.dtype).expand(b, -1, -1)
        new_attractors = self.in_ator_trans(attractors, vfeat)
        out = self.ator_out_trans(vfeat, new_attractors)
        out = resize_linear(out.reshape(b, h2, w2, self.feat_dim),
                            in_feat.shape[1:3])
        return in_feat + out


class Polyformer(nn.Module):
    """A stack of PolyformerLayers (reference polyformer.py:57-103)."""

    def __init__(self, feat_dim: int, num_layers: int = 1, **layer_kw):
        super().__init__()
        self.polyformer_layers = nn.ModuleList(
            PolyformerLayer(feat_dim, **layer_kw) for _ in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.polyformer_layers:
            x = layer(x)
        return x


def polyformer_param_labels(names: Iterable[str], opt_mode: str,
                            bn_modules: Optional[Iterable[str]] = None,
                            bn_opt_scheme: Optional[str] = None,
                            ) -> Dict[str, bool]:
    """{parameter name: trained} for the opt modes of ``opt_mode``
    (reference train2d.py:469-510). ``bn_modules``: the names of the
    modules that own running statistics; with ``bn_opt_scheme='affine'``
    their parameters train too. A name is matched as it is given: under
    DA the caller passes the wrapped model's names (``net.``...) and the
    net's own BatchNorm names, so ``h`` and ``affine`` match nothing there,
    as in JAX."""
    modes = opt_mode.split(",")
    bn = set(bn_modules or ()) if bn_opt_scheme == "affine" else set()
    labels = {}
    for name in names:
        trained = name.rsplit(".", 1)[0] in bn
        if "allnet" in modes:
            trained = True
        if "allpoly" in modes and ("polyformer_layers" in name
                                   or "translayers" in name):
            trained = True
        if "inator" in modes and "in_ator_trans" in name:
            trained = True
        if "k" in modes and "in_ator_trans.key" in name:
            trained = True
        if "q" in modes and "in_ator_trans.query" in name:
            trained = True
        if "v" in modes and "in_ator_trans.out_trans.first_linear" in name:
            trained = True
        if "h" in modes and name.startswith("outc"):
            trained = True
        labels[name] = trained
    return labels
