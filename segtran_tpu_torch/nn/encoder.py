"""SegtranFusionEncoder (reference segtran_shared.py:819-975; counterpart
of ``segtran_tpu/nn/encoder.py``).

Per layer i: vfeat -> affine LayerNorm -> (+ poscode[..., :dim_i]) ->
non-affine LayerNorm -> dropout (layer 0 only) -> * mask ->
SqueezedAttFeatTrans, or with ``use_squeezed_transformer=False`` one
CrossAttFeatTrans attending the N tokens to themselves (a
CrossMinceAttFeatTrans with ``use_mince_transformer``). The code is
computed once at trans_in_dim and sliced per layer; a ``bias`` code is
not added to the features but passed to every layer, whose scores it
biases (non-squeezed layers only, as in the reference; mince layers take
one bias per scale from the per-scale encoders ``pos_code_layers``). With
``use_attn_consist_loss`` every attention keeps its scores of the last
forward on its module (``attention_scores``); with ``keep_layer_outputs``
the encoder keeps each layer's output tokens in ``layer_outputs`` (JAX's
sown ``layer_{i}_vfeat``, ``nn/features.py``).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..configs.base import TransformerConfig
from ..ops.norm import LayerNorm
from .attention import (CrossAttFeatTrans, Dropout, SqueezedAttFeatTrans,
                        TransLayerSpec)
from .mince import CrossMinceAttFeatTrans, scaled_shape
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
        pos_code_weight=(cfg.pos_code_weight if cfg.pos_code_type == "bias"
                         else 1.0),
        ablate_multihead=cfg.ablate_multihead,
        fix_private_output_residual=cfg.fix_private_output_residual,
        reassociate=cfg.reassociate,
        use_fused_attention=cfg.use_fused_attention,
        use_fused_epilogue=cfg.use_fused_epilogue,
        keep_attn_diag=cfg.attn_diag,
        ln_eps=cfg.ln_eps,
        dtype=cfg.dtype,
    )


class SegtranFusionEncoder(nn.Module):
    """Stack of num_translayers squeezed (or cross) attention layers.
    ``token_grid``: the token grid the ``rand`` code's table is sized
    from (the other codes take it at each call)."""

    def __init__(self, cfg: TransformerConfig, token_grid=None):
        super().__init__()
        if cfg.use_squeezed_transformer and cfg.pos_code_type == "bias":
            raise ValueError(
                "Squeezed transformer cannot use positional biases; pass "
                "--nosqueeze to disable the squeezed transformer "
                "(reference segtran_shared.py:841-844)")
        self.cfg = cfg
        dims = cfg.translayer_dims
        self.pos_code_layer = SegtranPosEncoder(
            cfg.pos_code_type, cfg.pos_dim, cfg.trans_in_dim,
            pos_bias_radius=cfg.pos_bias_radius, ln_eps=cfg.ln_eps,
            dtype=cfg.dtype, spatial_shape=token_grid)
        n = cfg.num_translayers
        self.vfeat_norm_layers = nn.ModuleList(
            LayerNorm(dims[i], cfg.ln_eps, dtype=cfg.dtype) for i in range(n))
        self.comb_norm_layers = nn.ModuleList(
            LayerNorm(dims[i], cfg.ln_eps, affine=False, dtype=cfg.dtype)
            for i in range(n))
        # the attention-consistency loss reads every layer's scores
        # (train/da.collect_attn_scores); keeping them shuts the flash path
        keep = cfg.use_attn_consist_loss
        if cfg.use_squeezed_transformer:
            self.translayers = nn.ModuleList(
                SqueezedAttFeatTrans(layer_spec_from_config(cfg, i),
                                     num_attractors=cfg.num_attractors,
                                     has_FFN_in_squeeze=cfg.has_FFN_in_squeeze,
                                     keep_attn_scores=keep)
                for i in range(n))
        elif cfg.use_mince_transformer:
            self.translayers = nn.ModuleList(
                CrossMinceAttFeatTrans(layer_spec_from_config(cfg, i),
                                       cfg.mince_scales,
                                       cfg.mince_channel_props,
                                       keep_attn_scores=keep)
                for i in range(n))
            if cfg.pos_code_type == "bias":
                # shared by all layers (reference segtran_shared.py:856-861)
                self.pos_code_layers = nn.ModuleList(
                    SegtranPosEncoder("bias", cfg.pos_dim, cfg.trans_in_dim,
                                      pos_bias_radius=cfg.pos_bias_radius,
                                      ln_eps=cfg.ln_eps, dtype=cfg.dtype)
                    for _ in cfg.mince_scales)
        else:
            self.translayers = nn.ModuleList(
                CrossAttFeatTrans(layer_spec_from_config(cfg, i),
                                  keep_attn_scores=keep)
                for i in range(n))
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.keep_layer_outputs = False
        self.layer_outputs = None

    def forward(self, vfeat: torch.Tensor, voxels_pos: torch.Tensor,
                vmask: torch.Tensor, spatial_shape: Sequence[int]) -> torch.Tensor:
        """vfeat [B, N, C]; voxels_pos [B, N, pos_dim]; vmask [B, N, 1]
        multiplies the normalized features."""
        cfg = self.cfg
        pos_code = self.pos_code_layer(spatial_shape, voxels_pos)
        # a bias code biases the scores; it is added to the features at
        # weight 0, so they skip it (reference segtran_shared.py:846-850)
        pos_biases = pos_code if cfg.pos_code_type == "bias" else None
        mince = (not cfg.use_squeezed_transformer
                 and cfg.use_mince_transformer)
        if mince:
            mince_pos = None
            if hasattr(self, "pos_code_layers"):
                mince_pos = [enc(scaled_shape(spatial_shape, sc), voxels_pos)
                             for enc, sc in zip(self.pos_code_layers,
                                                cfg.mince_scales)]
        outs = [] if self.keep_layer_outputs else None
        for i, layer in enumerate(self.translayers):
            dim_i = cfg.translayer_dims[i]
            feat_normed = self.vfeat_norm_layers[i](vfeat)
            if cfg.pos_code_type not in ("none", "bias"):
                feat_comb = feat_normed + cfg.pos_code_weight * pos_code[:, :, :dim_i]
                feat_normed = self.comb_norm_layers[i](feat_comb)
            if i == 0:
                feat_normed = self.dropout(feat_normed)
            if mince:
                vfeat = layer(feat_normed * vmask, spatial_shape,
                              pos_biases=mince_pos)
            else:
                vfeat = layer(feat_normed * vmask, pos_biases=pos_biases)
            if outs is not None:
                outs.append(vfeat)
        self.layer_outputs = outs
        return vfeat
