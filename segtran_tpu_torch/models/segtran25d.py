"""Segtran25d: depth folded into the batch, a per-slice 2-D EfficientNet or
ResNet pyramid, re-assembled into volumes and fused by the 3-D position-coded
transformer, then a 3-D output FPN on depth-last volumes.

Counterpart of ``segtran_tpu/models/segtran25d.py`` (reference
code/networks/segtran25d.py: forward :380-477, in_fpn_forward :264-316,
out_fpn_forward :318-377). What differs from Segtran3d, as in JAX:

* ``D_groupsize`` G > 1 merges G consecutive slices into the channels
  before the bridge and the backbone (channel ``c*G + g``);
* ``stemconv``: the backbone's stem takes the (grouped) channels as they
  are; ``bridgeconv`` maps them to 3 with a 1x1x1 conv, ``dup3`` repeats
  one channel three times;
* coordinates in (H, W, D) order, the depth scale taken from the depth
  before grouping;
* the output FPN runs on depth-last volumes, and the ``conv`` depth unpool
  interleaves depth (``d*K + k``), unlike Segtran3d's block order.

``model.train()`` gives the training forward; with ``out_fpn_do_dropout``
and a hidden dropout above 0 the tail runs unfactored with dropout before
``out_conv3d`` (the same parameters as the factored tail). ``cfg.remat``
recomputes the backbone and the encoder, ``cfg.remat_blocks`` each
EfficientNet block, in the backward (``nn/remat.py``). Volumes are
[B, H, W, D, C] channels-last. Module names follow the JAX package.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..configs.base import Segtran25dConfig
from ..nn.attention import Dropout
from ..nn.encoder import SegtranFusionEncoder
from ..nn.heads import (Conv1x1Params, apply_pointwise, compose_1x1,
                        compose_fold_head)
from ..nn.poscode import gen_all_indices
from ..nn.remat import remat
from ..ops.resize import avg_pool_nhwc, resize_linear
from .segtran2d import _conv1x1, _GroupNorm, make_backbone


class Segtran25d(nn.Module):
    """``patch_size`` (H, W, D) of the model's input: needed only by the
    ``rand`` position code. ``input_scale`` (H, W, D) divides the position
    coordinates' scales (JAX segtran25d.py:131-133)."""

    def __init__(self, cfg: Segtran25dConfig,
                 patch_size: Optional[Sequence[int]] = None,
                 input_scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)):
        super().__init__()
        self.cfg = cfg
        self.input_scale = tuple(float(s) for s in input_scale)
        if not cfg.backbone_type.startswith(("eff-", "resnet")):
            # JAX's Segtran25d builds EfficientNet or ResNet only
            raise ValueError(f"Segtran25d takes an eff-* or resnet "
                             f"backbone, not {cfg.backbone_type}")
        c = cfg.orig_in_channels * cfg.D_groupsize
        scheme = cfg.inchan_to3_scheme
        stem_in = 3
        if c != 3:
            if scheme == "stemconv":
                stem_in = c
            elif scheme == "bridgeconv":
                self.in_bridge_to3 = nn.Conv3d(c, 3, 1)
            elif not (scheme == "dup3" and c == 1):
                raise ValueError(scheme)
        dims = cfg.bb_feat_dims
        self.backbone = make_backbone(cfg, in_channels=stem_in)
        for layer in cfg.in_fpn_layers[:-1]:
            setattr(self, f"in_fpn{layer}{layer + 1}_conv",
                    nn.Conv2d(dims[layer], dims[layer + 1], 1))
            setattr(self, f"in_gn{layer + 1}b",
                    _GroupNorm(cfg.G, dims[layer + 1], eps=1e-5))
        if dims[cfg.in_fpn_layers[-1]] != cfg.trans_in_dim:
            self.in_fpn_bridgeconv = nn.Conv2d(dims[cfg.in_fpn_layers[-1]],
                                               cfg.trans_in_dim, 1)
        grid = None
        if cfg.pos_code_type == "rand":
            if patch_size is None:
                raise ValueError("the rand position code needs the model's "
                                 "patch_size")
            grid = self.token_grid(patch_size)
        self.voxel_fusion = SegtranFusionEncoder(cfg, token_grid=grid)
        self.do_out_fpn = cfg.out_fpn_layers != cfg.in_fpn_layers
        self.extra_layers = (cfg.out_fpn_layers[:-len(cfg.in_fpn_layers)]
                             if self.do_out_fpn else ())
        for layer in self.extra_layers:
            setattr(self, f"out_fpn{layer}{layer + 1}_conv3d",
                    nn.Conv3d(dims[layer], dims[layer + 1], 1))
            setattr(self, f"out_gn{layer + 1}b",
                    _GroupNorm(cfg.G, dims[layer + 1], eps=1e-5))
        k = cfg.D_pool_K
        self.fold = (self.do_out_fpn and k > 1
                     and cfg.out_fpn_upsampleD_scheme == "conv")
        head_in = cfg.trans_out_dim
        if self.do_out_fpn:
            last_dim = dims[cfg.out_fpn_layers[-len(cfg.in_fpn_layers)]]
            self.out_fpn_bridgeconv3d = Conv1x1Params(
                last_dim, cfg.trans_out_dim, spatial_ndim=3)
            if self.fold:
                head_in = cfg.trans_out_dim // k
                self.out_fpn_upsampleD = Conv1x1Params(
                    cfg.trans_out_dim, head_in * k, spatial_ndim=3)
        self.out_conv3d = Conv1x1Params(head_in, cfg.num_classes,
                                        spatial_ndim=3)
        self.out_fpn_dropout = Dropout(cfg.hidden_dropout_prob)
        # the token grid (H2, W2, D3) of the last forward (the raster of the
        # attention-consistency loss)
        self.last_grid = None
        # with keep_features: the depth-pooled in-FPN volume [B, H2, W2, D3,
        # C] of the last forward (JAX's sown in_fpn_feat, nn/features.py)
        self.keep_features = False
        self.in_fpn_feat = None

    def _pool_stride(self) -> int:
        stride = 2 ** min(self.cfg.in_fpn_layers)
        return stride if self.cfg.bb_feat_upsize else 2 * stride

    def token_grid(self, patch_size: Sequence[int]) -> Tuple[int, int, int]:
        """The fused token grid (H2, W2, D3) of an input of (H, W, D)."""
        h, w, d = (int(s) for s in patch_size)
        ps = self._pool_stride()
        return (h // ps, w // ps,
                (d // self.cfg.D_groupsize) // self.cfg.D_pool_K)

    def _in_fpn(self, feats, dt):
        """The 2-D input FPN on the folded batch (segtran25d.py:264-289)."""
        cfg = self.cfg
        curr = feats[cfg.in_fpn_layers[0]]
        for layer in cfg.in_fpn_layers[:-1]:
            upconv = _conv1x1(curr, getattr(self,
                                            f"in_fpn{layer}{layer + 1}_conv"),
                              dt)
            higher = resize_linear(feats[layer + 1], upconv.shape[1:-1])
            norm = getattr(self, f"in_gn{layer + 1}b")
            curr = (norm.run(upconv + higher, dt) if cfg.in_fpn_scheme == "AN"
                    else norm.run(upconv, dt) + higher)
        if hasattr(self, "in_fpn_bridgeconv"):
            curr = _conv1x1(curr, self.in_fpn_bridgeconv, dt)
        return curr

    def forward(self, batch: torch.Tensor) -> torch.Tensor:
        """batch [B, H, W, D, C] -> logits [B, H, W, D, num_classes] fp32."""
        cfg = self.cfg
        dt = cfg.dtype
        b, h, w, d, c = batch.shape
        d_orig = d
        g = cfg.D_groupsize
        if g > 1:
            # G consecutive slices into the channels, c*G + g
            # (segtran25d.py:385-396)
            assert d % g == 0, (d, g)
            batch = batch.reshape(b, h, w, d // g, g, c).transpose(4, 5)
            d, c = d // g, c * g
            batch = batch.reshape(b, h, w, d, c)
        if hasattr(self, "in_bridge_to3"):
            batch = _conv1x1(batch, self.in_bridge_to3, dt)
        elif c == 1 and cfg.inchan_to3_scheme == "dup3":
            batch = batch.expand(b, h, w, d, 3)
        # depth into the batch: [B*D, H, W, c] (segtran25d.py:398-407)
        fake2d = batch.permute(0, 3, 1, 2, 4).reshape(b * d, h, w, -1)

        ps = self._pool_stride()
        pooled = avg_pool_nhwc(fake2d.abs().float(), (ps, ps))
        nonzero_mask = (pooled.sum(-1) > 0).float()

        rematted = cfg.remat and self.training and torch.is_grad_enabled()
        feats = (remat(self.backbone, fake2d) if rematted
                 else self.backbone(fake2d))
        curr = self._in_fpn(feats, dt)

        # unfold depth to [B, H2, W2, D, C], depth-pool to D3 (:291-316)
        h2, w2 = curr.shape[1:3]
        vol = curr.reshape(b, d, h2, w2, -1).permute(0, 2, 3, 1, 4)
        d3 = d // cfg.D_pool_K
        vol = resize_linear(vol, (h2, w2, d3))
        maskv = nonzero_mask.reshape(b, d, h2, w2).permute(0, 2, 3, 1)
        maskv = resize_linear(maskv[..., None], (h2, w2, d3))[..., 0]
        vmask = (maskv >= 0.5).to(dt)
        n = h2 * w2 * d3
        vfeat_fpn = vol.reshape(b, n, cfg.trans_in_dim)
        self.last_grid = (h2, w2, d3)
        self.in_fpn_feat = vol if self.keep_features else None

        # coordinates in (H, W, D) order; the depth scale from the depth
        # before grouping (segtran25d.py:413-436)
        scale_h, scale_w, scale_d = h // h2, w // w2, d_orig // d3
        assert (scale_h * h2 == h and scale_w * w2 == w
                and scale_d * d3 == d_orig), \
            "the volume must be divisible by the FPN grid"
        sh, sw, sd = self.input_scale
        xyz = gen_all_indices((h2, w2, d3), device=batch.device)
        xyz = xyz.reshape(-1, 3).float() * torch.tensor(
            [[scale_h / sh, scale_w / sw, scale_d / sd]], dtype=torch.float32,
            device=batch.device)
        voxels_pos = xyz[None].expand(b, n, 3)

        enc_args = (vfeat_fpn, voxels_pos, vmask.reshape(b, n)[..., None],
                    (h2, w2, d3))
        vfeat_fused = (remat(self.voxel_fusion, *enc_args) if rematted
                       else self.voxel_fusion(*enc_args))
        vfeat_fused = vfeat_fused.reshape(b, h2, w2, d3, cfg.trans_out_dim)

        if not self.do_out_fpn:
            scores = apply_pointwise(vfeat_fused, *self.out_conv3d.matrix())
            return resize_linear(scores.float(), (h, w, d_orig))

        def to_vol(f2d):
            hh, ww = f2d.shape[1:3]
            return f2d.reshape(b, d, hh, ww, -1).permute(0, 2, 3, 1, 4)

        # the 3-D output FPN on depth-last volumes (segtran25d.py:318-377)
        curr = to_vol(feats[cfg.out_fpn_layers[0]])
        for layer in self.extra_layers:
            upconv = _conv1x1(curr, getattr(
                self, f"out_fpn{layer}{layer + 1}_conv3d"), dt)
            higher = resize_linear(to_vol(feats[layer + 1]),
                                   upconv.shape[1:-1])
            norm = getattr(self, f"out_gn{layer + 1}b")
            curr = (norm.run(upconv + higher, dt)
                    if cfg.out_fpn_scheme == "AN"
                    else norm.run(upconv, dt) + higher)
        if (cfg.out_fpn_do_dropout and self.training
                and cfg.hidden_dropout_prob > 0):
            scores = self._unfactored_tail(curr, vfeat_fused)
        else:
            scores = self._factored_tail(curr, vfeat_fused)
        return resize_linear(scores.float(), (h, w, d_orig))

    def _factored_tail(self, curr, vfeat_fused):
        """The linear tail reassociated (nn/heads.py), depth last."""
        cfg, k = self.cfg, self.cfg.D_pool_K
        wo, bo = self.out_conv3d.matrix()
        if self.fold:
            wu, bu = self.out_fpn_upsampleD.matrix()
            wo, bo = compose_fold_head(wu, bu, wo, bo, k)
        w_comp, b_comp = compose_1x1(*self.out_fpn_bridgeconv3d.matrix(),
                                     wo, bo)
        scores = apply_pointwise(curr, w_comp, b_comp)
        fused_cls = apply_pointwise(vfeat_fused, wo)          # bias in b_comp
        scores = scores + resize_linear(fused_cls, curr.shape[1:-1])
        bb, hh, ww, dd, _ = scores.shape
        if self.fold:
            # channels (kk, cls) -> depth d*K + kk, the interleaved order
            # (segtran25d.py:362-366): (d, kk) is already lexicographic
            return scores.reshape(bb, hh, ww, dd * k, cfg.num_classes)
        if k > 1 and cfg.out_fpn_upsampleD_scheme in ("interp",
                                                      "interpolate"):
            return resize_linear(scores, (hh, ww, dd * k))
        return scores

    def _unfactored_tail(self, curr, vfeat_fused):
        """The tail in the reference's order (JAX segtran25d.py:200-226):
        bridge conv + the upsampled fused features, the depth unpool,
        dropout, out_conv3d."""
        cfg, k = self.cfg, self.cfg.D_pool_K
        out_feat = (apply_pointwise(curr, *self.out_fpn_bridgeconv3d.matrix())
                    + resize_linear(vfeat_fused, curr.shape[1:-1]))
        if self.fold:
            ups = apply_pointwise(out_feat, *self.out_fpn_upsampleD.matrix())
            bb, hh, ww, dd, _ = ups.shape
            # channel f*K + kk -> (f, kk); depth (d, kk) -> d*K + kk
            out_feat = ups.reshape(bb, hh, ww, dd, -1, k).transpose(
                4, 5).reshape(bb, hh, ww, dd * k, -1)
        elif k > 1 and cfg.out_fpn_upsampleD_scheme in ("interp",
                                                        "interpolate"):
            hh, ww, dd = out_feat.shape[1:4]
            out_feat = resize_linear(out_feat, (hh, ww, dd * k))
        return apply_pointwise(self.out_fpn_dropout(out_feat),
                               *self.out_conv3d.matrix())
