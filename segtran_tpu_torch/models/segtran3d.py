"""Segtran3d: I3D backbone -> 3D input FPN with depth pooling ->
3D-position-coded squeezed fusion transformer -> factored output-FPN tail
with depth unpooling -> trilinear resize. ``model.train()`` gives the
training forward: I3D BatchNorm on batch statistics, dropout at the JAX
sites; the factored linear head stays, as in JAX while out-FPN dropout is
inactive. ``cfg.remat`` recomputes the backbone and the encoder in the
backward (``nn/remat.py``: the running statistics move once).

Counterpart of ``segtran_tpu/models/segtran3d.py`` (reference
code/networks/segtran3d.py: forward :398-498, in_fpn_forward :285-334,
out_fpn_forward :336-396, get_mask :266-270, channel->3 bridge :117-139).
Volumes are [B, H, W, D, C] channels-last; inside, depth moves to the I3D
frame axis ([B, D, H, W, C]). Module names follow the JAX package, so
converted weights load by name.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import Segtran3dConfig
from ..nn.backbones.i3d import I3DFeatures
from ..nn.encoder import SegtranFusionEncoder
from ..nn.heads import (Conv1x1Params, apply_pointwise, compose_1x1,
                        compose_fold_head)
from ..nn.poscode import gen_all_indices
from ..nn.remat import remat
from ..ops.resize import avg_pool_nhwc, resize_linear
from .segtran2d import _conv1x1, _GroupNorm, init_segtran2d


class Segtran3d(nn.Module):
    def __init__(self, cfg: Segtran3dConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.backbone_type != "i3d":
            raise NotImplementedError(
                f"backbone {cfg.backbone_type} belongs to a later slice of "
                f"the port (this slice has the I3D backbone)")
        if cfg.out_fpn_layers == cfg.in_fpn_layers:
            raise NotImplementedError(
                "the no-out-FPN head belongs to a later slice of the port")
        if cfg.orig_in_channels != 3:
            if cfg.inchan_to3_scheme != "bridgeconv":
                raise NotImplementedError(
                    f"inchan_to3_scheme {cfg.inchan_to3_scheme} belongs to "
                    f"a later slice of the port (this slice has "
                    f"bridgeconv)")
            self.in_bridge_to3 = nn.Conv3d(cfg.orig_in_channels, 3, 1)
        dims = cfg.bb_feat_dims
        self.backbone = I3DFeatures(do_pool1=not cfg.bb_feat_upsize,
                                    dtype=cfg.dtype)
        for layer in cfg.in_fpn_layers[:-1]:
            setattr(self, f"in_fpn{layer}{layer + 1}_conv",
                    nn.Conv3d(dims[layer], dims[layer + 1], 1))
            setattr(self, f"in_gn{layer + 1}b",
                    _GroupNorm(cfg.G, dims[layer + 1], eps=1e-5))
        if dims[cfg.in_fpn_layers[-1]] != cfg.trans_in_dim:
            self.in_fpn_bridgeconv = nn.Conv3d(dims[cfg.in_fpn_layers[-1]],
                                               cfg.trans_in_dim, 1)
        self.voxel_fusion = SegtranFusionEncoder(cfg)
        self.extra_layers = cfg.out_fpn_layers[:-len(cfg.in_fpn_layers)]
        for layer in self.extra_layers:
            setattr(self, f"out_fpn{layer}{layer + 1}_conv3d",
                    nn.Conv3d(dims[layer], dims[layer + 1], 1))
            setattr(self, f"out_gn{layer + 1}b",
                    _GroupNorm(cfg.G, dims[layer + 1], eps=1e-5))
        k = cfg.D_pool_K
        self.fold = k > 1 and cfg.out_fpn_upsampleD_scheme == "conv"
        last_dim = dims[cfg.out_fpn_layers[-len(cfg.in_fpn_layers)]]
        self.out_fpn_bridgeconv3d = Conv1x1Params(
            last_dim, cfg.trans_out_dim, spatial_ndim=3)
        head_in = cfg.trans_out_dim
        if self.fold:
            head_in = cfg.trans_out_dim // k
            self.out_fpn_upsampleD = Conv1x1Params(
                cfg.trans_out_dim, head_in * k, spatial_ndim=3)
        self.out_conv3d = Conv1x1Params(head_in, cfg.num_classes,
                                        spatial_ndim=3)

    def _fpn_step(self, name, norm, curr, higher, scheme, dt):
        upconv = _conv1x1(curr, getattr(self, name), dt)
        higher = resize_linear(higher, upconv.shape[1:-1])
        norm = getattr(self, norm)
        if scheme == "AN":
            return norm.run(upconv + higher, dt)
        return norm.run(upconv, dt) + higher

    def forward(self, batch: torch.Tensor) -> torch.Tensor:
        """batch [B, H, W, D, C] -> logits [B, H, W, D, num_classes] fp32."""
        cfg = self.cfg
        dt = cfg.dtype
        if (self.training and cfg.out_fpn_do_dropout
                and cfg.hidden_dropout_prob > 0):
            raise NotImplementedError(
                "out-FPN dropout in training (the unfactored tail, --outdrop "
                "with --dropout > 0) belongs to a later slice of the port")
        b, h, w, d, _ = batch.shape
        rgb = (_conv1x1(batch, self.in_bridge_to3, dt)
               if hasattr(self, "in_bridge_to3") else batch.to(dt))
        vol = rgb.permute(0, 3, 1, 2, 4)                       # [B,D,H,W,3]

        # nonzero mask; pool window (D, H, W) (segtran3d.py:147-161)
        if cfg.bb_feat_upsize:
            pool = {2: (2, 4, 4), 3: (4, 8, 8)}.get(min(cfg.in_fpn_layers),
                                                    (8, 16, 16))
        else:
            pool = {2: (2, 8, 8), 3: (4, 16, 16)}.get(min(cfg.in_fpn_layers),
                                                      (8, 32, 32))
        pooled = avg_pool_nhwc(vol.abs(), pool)
        nonzero_mask = (pooled.sum(-1) > 0).float()

        rematted = cfg.remat and self.training and torch.is_grad_enabled()
        feats = remat(self.backbone, vol) if rematted else self.backbone(vol)

        # input FPN
        curr = feats[cfg.in_fpn_layers[0]]
        for layer in cfg.in_fpn_layers[:-1]:
            curr = self._fpn_step(f"in_fpn{layer}{layer + 1}_conv",
                                  f"in_gn{layer + 1}b", curr, feats[layer + 1],
                                  cfg.in_fpn_scheme, dt)
        if hasattr(self, "in_fpn_bridgeconv"):
            curr = _conv1x1(curr, self.in_fpn_bridgeconv, dt)

        # depth pooling by D_pool_K as a trilinear resize (:315-323)
        d1, h2, w2 = curr.shape[1:4]
        d2 = d1 // cfg.D_pool_K
        curr = resize_linear(curr, (d2, h2, w2))
        mask_p = resize_linear(nonzero_mask[..., None], (d2, h2, w2))
        vmask = (mask_p[..., 0] >= 0.5).to(dt)
        n = d2 * h2 * w2
        vfeat_fpn = curr.reshape(b, n, cfg.trans_in_dim)

        # positional coordinates in (D, H, W) order (:442-470)
        scale_d, scale_h, scale_w = d // d2, h // h2, w // w2
        assert scale_d * d2 == d and scale_h * h2 == h and scale_w * w2 == w, \
            "the volume must be divisible by the FPN grid"
        zyx = gen_all_indices((d2, h2, w2), device=batch.device)
        zyx = zyx.reshape(-1, 3).float() * torch.tensor(
            [[scale_d, scale_h, scale_w]], dtype=torch.float32,
            device=batch.device)
        voxels_pos = zyx[None].expand(b, n, 3)

        enc_args = (vfeat_fpn, voxels_pos, vmask.reshape(b, n)[..., None],
                    (d2, h2, w2))
        vfeat_fused = (remat(self.voxel_fusion, *enc_args) if rematted
                       else self.voxel_fusion(*enc_args))
        vfeat_fused = vfeat_fused.reshape(b, d2, h2, w2, cfg.trans_out_dim)

        # output FPN with the factored linear tail (nn/heads.py)
        curr = feats[cfg.out_fpn_layers[0]]
        for layer in self.extra_layers:
            curr = self._fpn_step(f"out_fpn{layer}{layer + 1}_conv3d",
                                  f"out_gn{layer + 1}b", curr,
                                  feats[layer + 1], cfg.out_fpn_scheme, dt)
        k = cfg.D_pool_K
        wo, bo = self.out_conv3d.matrix()
        if self.fold:
            wu, bu = self.out_fpn_upsampleD.matrix()
            wo, bo = compose_fold_head(wu, bu, wo, bo, k)
        w_comp, b_comp = compose_1x1(*self.out_fpn_bridgeconv3d.matrix(),
                                     wo, bo)
        scores = apply_pointwise(curr, w_comp, b_comp)
        fused_cls = apply_pointwise(vfeat_fused, wo)          # bias in b_comp
        scores = scores + resize_linear(fused_cls, curr.shape[1:-1])
        bb, dd, hh, ww, _ = scores.shape
        if self.fold:
            # channels (kk, cls) -> depth kk*D + d (segtran3d.py:376-379)
            scores = scores.reshape(bb, dd, hh, ww, k, cfg.num_classes)
            scores = scores.permute(0, 4, 1, 2, 3, 5).reshape(
                bb, k * dd, hh, ww, cfg.num_classes)
        elif k > 1 and cfg.out_fpn_upsampleD_scheme == "interp":
            scores = resize_linear(scores, (dd * k, hh, ww))
        scores = scores.permute(0, 2, 3, 1, 4)          # depth last
        return resize_linear(scores.float(), (h, w, d))


def init_segtran3d(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random init with the JAX package's initializer families
    (see init_segtran2d)."""
    return init_segtran2d(model, seed)
