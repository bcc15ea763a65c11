"""Typed configuration for Segtran2d (serving, training), Segtran3d and
Segtran25d (whole-volume inference, training).

Counterpart of ``segtran_tpu/configs/base.py``: the same frozen dataclasses,
field names and ``derive()`` rules (layer-compression cumprod, FPN check),
with ``dtype`` held as a torch dtype. Only the fields the ported paths read
are kept (serving, 2-D training, 3-D evaluation, 3-D training).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np
import torch

# Per-backbone channel dims of the 5-level feature pyramid
# (reference segtran_shared.py:15-26).
BACKBONE_FEAT_DIMS = {
    "resnet34":  (64, 64, 128, 256, 512),
    "resnet50":  (64, 256, 512, 1024, 2048),
    "resnet101": (64, 256, 512, 1024, 2048),
    "eff-tiny":  (8, 8, 16, 40, 448),
    "eff-b0":    (16, 24, 40, 112, 1280),
    "eff-b1":    (16, 24, 40, 112, 1280),
    "eff-b2":    (16, 24, 48, 120, 1408),
    "eff-b3":    (24, 32, 48, 136, 1536),
    "eff-b4":    (24, 32, 56, 160, 1792),
    "eff-b5":    (24, 40, 64, 176, 2048),
    "effv2s":    (24, 48, 64, 160, 256),
    "effv2m":    (24, 48, 80, 176, 512),
    "effv2l":    (32, 64, 96, 224, 640),
    "i3d":       (64, 192, 480, 832, 1024),
}


def feat_dims(backbone_type: str) -> Tuple[int, ...]:
    """The pyramid widths of a Segtran backbone; a backbone without them
    (resnet18 / resnet152, as in the JAX package) is refused."""
    if backbone_type not in BACKBONE_FEAT_DIMS:
        raise ValueError(
            f"Segtran has no feature widths for backbone {backbone_type!r}; "
            f"it takes one of {sorted(BACKBONE_FEAT_DIMS)} (resnet18 and "
            f"resnet152 serve only the zoo nets)")
    return BACKBONE_FEAT_DIMS[backbone_type]


def _derive_translayer_dims(orig_in_feat_dim: int,
                            compress_ratios: Tuple[float, ...]) -> Tuple[int, ...]:
    """Adjacent compression ratios -> per-layer dims via cumulative product
    (reference segtran_shared.py:177-183): ``(1, 1, 2, 2)`` gives
    ``orig / (1, 1, 2, 4)``."""
    abs_ratios = np.cumprod(np.asarray(compress_ratios, dtype=np.float64))
    return tuple(int(orig_in_feat_dim / r) for r in abs_ratios)


@dataclass(frozen=True)
class TransformerConfig:
    """Application-independent transformer settings
    (reference segtran_shared.py:90-156)."""
    translayer_dims: Tuple[int, ...] = (1792, 1792)

    num_modes: int = 4
    use_squeezed_transformer: bool = True
    num_attractors: int = 256
    tie_qk_scheme: str = "shared"          # shared | loose | none
    mid_type: str = "shared"               # shared | private | none
    trans_output_type: str = "private"     # shared | private
    has_FFN: bool = True
    has_FFN_in_squeeze: bool = False

    pos_code_type: str = "lsinu"           # lsinu | rand | sinu | none | bias
    pos_code_weight: float = 1.0
    pos_bias_radius: int = 7
    pos_dim: int = 2

    qk_have_bias: bool = True
    v_has_bias: bool = False
    attn_clip: float = 500.0

    pool_modes_feat: str = "softmax"       # softmax | max | mean | none

    # dropout in training (reference segtran_shared.py:90-156)
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    # dropout on the out-FPN features in training (the unfactored tail)
    out_fpn_do_dropout: bool = False
    # standard multi-head attention output in place of the expansion block
    ablate_multihead: bool = False
    # keep each layer's attention scores for the trainer's
    # attention-consistency loss (train/da.py); turns the flash path off
    use_attn_consist_loss: bool = False
    # the mince (multi-scale, channel-partitioned) layers of the
    # non-squeezed encoder (nn/mince.py); the squeezed encoder ignores them
    use_mince_transformer: bool = False
    mince_scales: Any = None               # e.g. (2, 1)
    mince_channel_props: Any = None        # e.g. (1.0, 1.0)
    # keep each non-fused attention's (max, positive mean, clamped) score
    # statistics for train2d's --attndiag line (reference
    # segtran_shared.py:569-587)
    attn_diag: bool = False
    # the reference init passes (nn/init.py)
    base_initializer_range: float = 0.02
    query_idbias_scale: float = 10.0
    feattrans_lin1_idbias_scale: float = 10.0

    # CUDA flash cross-attention (kernels/squeezed_attention.py) in the
    # squeezed layers; in training only without attention dropout.
    use_fused_attention: bool = False
    # CUDA fused private-output + LayerNorm + mode-pool epilogue
    # (kernels/expansion_epilogue.py); inference-only.
    use_fused_epilogue: bool = False
    # exact matmul reassociations exploiting A << N in the squeezed layers
    reassociate: bool = True
    # the reference's MMPrivateOutput drops its residual; True corrects it
    fix_private_output_residual: bool = False
    # recompute the backbone and the encoder in the backward (nn/remat.py)
    remat: bool = False
    # recompute each EfficientNet block in the backward (Segtran2d)
    remat_blocks: bool = False

    ln_eps: float = 1e-12
    dtype: Any = torch.float32             # compute dtype; params stay fp32

    @property
    def num_translayers(self) -> int:
        return len(self.translayer_dims) - 1

    @property
    def trans_in_dim(self) -> int:
        return self.translayer_dims[0]

    @property
    def trans_out_dim(self) -> int:
        return self.translayer_dims[-1]


@dataclass(frozen=True)
class Segtran2dConfig(TransformerConfig):
    """2D variant defaults (reference segtran2d.py:16-63)."""
    backbone_type: str = "eff-b4"
    bb_feat_upsize: bool = True            # stem stride 1
    in_fpn_layers: Tuple[int, ...] = (3, 4)
    out_fpn_layers: Tuple[int, ...] = (1, 2, 3, 4)
    in_fpn_scheme: str = "AN"              # AN: add then norm; NA: norm then add
    out_fpn_scheme: str = "AN"
    # BatchNorm (momentum 0.9, eps 1e-5) in place of the FPNs' GroupNorm
    in_fpn_use_bn: bool = False
    out_fpn_use_bn: bool = False
    G: int = 8                             # groups in GroupNorm
    num_classes: int = 2
    # > 0: inputs [B, H, W, C, MOD], modalities max-fused after the in-FPN
    num_modalities: int = 0
    # a learned global bias in place of the fusion transformer
    use_global_bias: bool = False
    translayer_compress_ratios: Tuple[float, ...] = (1.0, 1.0)

    @property
    def bb_feat_dims(self) -> Tuple[int, ...]:
        return feat_dims(self.backbone_type)

    @property
    def orig_in_feat_dim(self) -> int:
        return self.bb_feat_dims[self.in_fpn_layers[-1]]

    def derive(self, **overrides) -> "Segtran2dConfig":
        """Config with translayer_dims derived from the compression ratios;
        validates FPN layer compatibility (reference
        segtran_shared.py:158-196)."""
        cfg = dataclasses.replace(self, **overrides) if overrides else self
        if cfg.out_fpn_layers[-1] > cfg.in_fpn_layers[-1]:
            raise ValueError(
                f"in_fpn_layers={cfg.in_fpn_layers} is not compatible with "
                f"out_fpn_layers={cfg.out_fpn_layers}")
        dims = _derive_translayer_dims(cfg.orig_in_feat_dim,
                                       cfg.translayer_compress_ratios)
        return dataclasses.replace(cfg, translayer_dims=dims)


@dataclass(frozen=True)
class Segtran3dConfig(TransformerConfig):
    """3D variant defaults (reference segtran3d.py:19-77)."""
    backbone_type: str = "i3d"
    bb_feat_upsize: bool = True            # no I3D pool 1
    in_fpn_layers: Tuple[int, ...] = (3, 4)
    out_fpn_layers: Tuple[int, ...] = (1, 2, 3, 4)
    in_fpn_scheme: str = "AN"
    out_fpn_scheme: str = "AN"
    G: int = 8
    pos_dim: int = 3
    num_attractors: int = 1024
    num_classes: int = 4
    translayer_compress_ratios: Tuple[float, ...] = (1.0, 1.0)
    # BraTS 4-modality -> 3-channel bridge for I3D (segtran3d.py:117-139)
    inchan_to3_scheme: str = "bridgeconv"
    orig_in_channels: int = 4
    # depth pooling of the in-FPN features before the transformer
    D_pool_K: int = 2
    # Segtran25d: G consecutive depth slices merge into the channels before
    # the per-slice backbone (segtran25d.py:385-396)
    D_groupsize: int = 1
    out_fpn_upsampleD_scheme: str = "interp"   # interp | conv | none

    @property
    def bb_feat_dims(self) -> Tuple[int, ...]:
        return feat_dims(self.backbone_type)

    @property
    def orig_in_feat_dim(self) -> int:
        return self.bb_feat_dims[self.in_fpn_layers[-1]]

    derive = Segtran2dConfig.derive


@dataclass(frozen=True)
class Segtran25dConfig(Segtran3dConfig):
    """2.5D variant defaults (reference segtran25d.py:15-74): depth folded
    into the batch, a per-slice 2-D EfficientNet, 3-D position-coded
    fusion."""
    backbone_type: str = "eff-b3"
    inchan_to3_scheme: str = "stemconv"
    out_fpn_upsampleD_scheme: str = "conv"
