"""SegtranFusionEncoder, squeezed branch (reference
segtran_shared.py:819-975; counterpart of ``segtran_tpu/nn/encoder.py``).

Per layer i: vfeat -> affine LayerNorm -> (+ poscode[..., :dim_i]) ->
non-affine LayerNorm -> dropout (layer 0 only) -> * mask ->
SqueezedAttFeatTrans. The code is computed once at trans_in_dim and sliced
per layer.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..configs.base import TransformerConfig
from ..ops.norm import LayerNorm
from .attention import Dropout, SqueezedAttFeatTrans, TransLayerSpec
from .poscode import SegtranPosEncoder


def layer_spec_from_config(cfg: TransformerConfig, layer_i: int) -> TransLayerSpec:
    """Per-layer spec: in=dims[i], out=dims[i+1]
    (reference segtran_shared.py:880-884)."""
    return TransLayerSpec(
        in_feat_dim=cfg.translayer_dims[layer_i],
        feat_dim=cfg.translayer_dims[layer_i + 1],
        num_modes=cfg.num_modes,
        qk_have_bias=cfg.qk_have_bias,
        v_has_bias=cfg.v_has_bias,
        tie_qk_scheme=cfg.tie_qk_scheme,
        attn_clip=cfg.attn_clip,
        has_FFN=cfg.has_FFN,
        mid_type=cfg.mid_type,
        trans_output_type=cfg.trans_output_type,
        pool_modes_feat=cfg.pool_modes_feat,
        attention_probs_dropout_prob=cfg.attention_probs_dropout_prob,
        hidden_dropout_prob=cfg.hidden_dropout_prob,
        fix_private_output_residual=cfg.fix_private_output_residual,
        reassociate=cfg.reassociate,
        use_fused_attention=cfg.use_fused_attention,
        use_fused_epilogue=cfg.use_fused_epilogue,
        ln_eps=cfg.ln_eps,
        dtype=cfg.dtype,
    )


class SegtranFusionEncoder(nn.Module):
    """Stack of num_translayers squeezed attention layers."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        if not cfg.use_squeezed_transformer:
            raise NotImplementedError(
                "the non-squeezed encoder (--nosqueeze) belongs to a later "
                "slice of the port")
        self.cfg = cfg
        dims = cfg.translayer_dims
        self.pos_code_layer = SegtranPosEncoder(
            cfg.pos_code_type, cfg.pos_dim, cfg.trans_in_dim,
            ln_eps=cfg.ln_eps, dtype=cfg.dtype)
        n = cfg.num_translayers
        self.vfeat_norm_layers = nn.ModuleList(
            LayerNorm(dims[i], cfg.ln_eps, dtype=cfg.dtype) for i in range(n))
        self.comb_norm_layers = nn.ModuleList(
            LayerNorm(dims[i], cfg.ln_eps, affine=False, dtype=cfg.dtype)
            for i in range(n))
        self.translayers = nn.ModuleList(
            SqueezedAttFeatTrans(layer_spec_from_config(cfg, i),
                                 num_attractors=cfg.num_attractors,
                                 has_FFN_in_squeeze=cfg.has_FFN_in_squeeze)
            for i in range(n))
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, vfeat: torch.Tensor, voxels_pos: torch.Tensor,
                vmask: torch.Tensor, spatial_shape: Sequence[int]) -> torch.Tensor:
        """vfeat [B, N, C]; voxels_pos [B, N, pos_dim]; vmask [B, N, 1]
        multiplies the normalized features."""
        cfg = self.cfg
        pos_code = self.pos_code_layer(spatial_shape, voxels_pos)
        for i, layer in enumerate(self.translayers):
            dim_i = cfg.translayer_dims[i]
            feat_normed = self.vfeat_norm_layers[i](vfeat)
            if cfg.pos_code_type != "none":
                feat_comb = feat_normed + cfg.pos_code_weight * pos_code[:, :, :dim_i]
                feat_normed = self.comb_norm_layers[i](feat_comb)
            if i == 0:
                feat_normed = self.dropout(feat_normed)
            vfeat = layer(feat_normed * vmask)
        return vfeat
