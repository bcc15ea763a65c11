from .base import (BACKBONE_FEAT_DIMS, Segtran2dConfig, Segtran3dConfig,
                   Segtran25dConfig, TransformerConfig)

__all__ = ["BACKBONE_FEAT_DIMS", "Segtran2dConfig", "Segtran3dConfig",
           "Segtran25dConfig", "TransformerConfig"]
