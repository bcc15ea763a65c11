"""Segtran3d: I3D backbone -> 3D input FPN with depth pooling ->
3D-position-coded fusion transformer -> output FPN with depth unpooling ->
trilinear resize. ``model.train()`` gives the training forward: I3D
BatchNorm on batch statistics, dropout at the JAX sites. The output-FPN
tail is factored (every op at num_classes channels, ``nn/heads.py``)
except in training with ``out_fpn_do_dropout`` and a hidden dropout above
0, where JAX runs it unfactored with dropout before ``out_conv3d``; both
tails read the same parameters, so one checkpoint runs both. With
``out_fpn_layers == in_fpn_layers`` a 1x1 head sits on the fused grid.
``cfg.remat`` recomputes the backbone and the encoder in the backward
(``nn/remat.py``: the running statistics move once).

Counterpart of ``segtran_tpu/models/segtran3d.py`` (reference
code/networks/segtran3d.py: forward :398-498, in_fpn_forward :285-334,
out_fpn_forward :336-396, get_mask :266-270, channel->3 bridge :117-139).
Volumes are [B, H, W, D, C] channels-last; inside, depth moves to the I3D
frame axis ([B, D, H, W, C]). Module names follow the JAX package, so
converted weights load by name.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..configs.base import Segtran3dConfig
from ..nn.attention import Dropout
from ..nn.backbones.i3d import I3DFeatures
from ..nn.encoder import SegtranFusionEncoder
from ..nn.heads import (Conv1x1Params, apply_pointwise, compose_1x1,
                        compose_fold_head)
from ..nn.poscode import gen_all_indices
from ..nn.remat import remat
from ..ops.resize import avg_pool_nhwc, resize_linear
from .segtran2d import _conv1x1, _GroupNorm, init_segtran2d

# avgto3: [channels, 3] maps of the channels to "RGB" (JAX
# segtran3d.py:49-53): 4 channels -> (c0, (c1 + c2) / 2, c3), 2 channels ->
# (c0, (c0 + c1) / 2, c1). JAX transposes the 2-channel matrix to [3, 2],
# so its product with a [..., 2] volume raises; the port applies the
# matrix the reference means.
_AVGTO3 = {4: ((1, 0, 0), (0, 0.5, 0), (0, 0.5, 0), (0, 0, 1)),
           2: ((1, 0.5, 0), (0, 0.5, 1))}


def avgto3_matrix(channels: int) -> torch.Tensor:
    """[channels, 3] fp32."""
    if channels not in _AVGTO3:
        raise ValueError("avgto3 needs 2 or 4 channels")
    return torch.tensor(_AVGTO3[channels], dtype=torch.float32)


class Segtran3d(nn.Module):
    """``patch_size`` (H, W, D) of the model's input: needed only by the
    ``rand`` position code, whose table has one row per token.
    ``input_scale`` (H, W, D) divides the position coordinates' scales
    (JAX segtran3d.py:112-115)."""

    def __init__(self, cfg: Segtran3dConfig,
                 patch_size: Optional[Sequence[int]] = None,
                 input_scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)):
        super().__init__()
        self.cfg = cfg
        self.input_scale = tuple(float(s) for s in input_scale)
        if cfg.backbone_type != "i3d":
            raise ValueError(
                f"backbone {cfg.backbone_type}: the 3-D Segtran takes one "
                f"backbone, i3d (as JAX's Segtran3d, which builds only "
                f"I3DFeatures)")
        c = cfg.orig_in_channels
        if c != 3:
            scheme = cfg.inchan_to3_scheme
            if scheme == "bridgeconv":
                self.in_bridge_to3 = nn.Conv3d(c, 3, 1)
            elif scheme == "avgto3":
                self.register_buffer("avgto3", avgto3_matrix(c),
                                     persistent=False)
            elif not (scheme == "dup3" and c == 1):
                raise ValueError(f"unsupported inchan_to3_scheme {scheme}")
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
        # the token grid (D2, H2, W2) of the last forward: the raster the
        # attention-consistency loss resizes the mask to
        self.last_grid = None
        # with keep_features: the depth-pooled in-FPN volume [B, D2, H2, W2,
        # C] of the last forward (JAX's sown in_fpn_feat, nn/features.py)
        self.keep_features = False
        self.in_fpn_feat = None

    def _pool_window(self):
        """The nonzero mask's pool window (D, H, W): the stride of the
        in-FPN's lowest layer (segtran3d.py:147-161)."""
        cfg = self.cfg
        if cfg.bb_feat_upsize:
            return {2: (2, 4, 4), 3: (4, 8, 8)}.get(min(cfg.in_fpn_layers),
                                                    (8, 16, 16))
        return {2: (2, 8, 8), 3: (4, 16, 16)}.get(min(cfg.in_fpn_layers),
                                                  (8, 32, 32))

    def token_grid(self, patch_size: Sequence[int]) -> Tuple[int, int, int]:
        """The fused token grid (D2, H2, W2) of an input of (H, W, D)."""
        h, w, d = (int(s) for s in patch_size)
        pd, ph, pw = self._pool_window()
        return (d // pd) // self.cfg.D_pool_K, h // ph, w // pw

    def _fpn_step(self, name, norm, curr, higher, scheme, dt):
        upconv = _conv1x1(curr, getattr(self, name), dt)
        higher = resize_linear(higher, upconv.shape[1:-1])
        norm = getattr(self, norm)
        if scheme == "AN":
            return norm.run(upconv + higher, dt)
        return norm.run(upconv, dt) + higher

    def _to_rgb(self, batch: torch.Tensor, dt) -> torch.Tensor:
        """The channels -> 3 bridge (segtran3d.py:117-139)."""
        if hasattr(self, "in_bridge_to3"):
            return _conv1x1(batch, self.in_bridge_to3, dt)
        if hasattr(self, "avgto3"):
            return (batch.float() @ self.avgto3).to(dt)
        if batch.shape[-1] == 1:
            return batch.to(dt).expand(*batch.shape[:-1], 3)
        return batch.to(dt)

    def forward(self, batch: torch.Tensor) -> torch.Tensor:
        """batch [B, H, W, D, C] -> logits [B, H, W, D, num_classes] fp32."""
        cfg = self.cfg
        dt = cfg.dtype
        b, h, w, d, _ = batch.shape
        vol = self._to_rgb(batch, dt).permute(0, 3, 1, 2, 4)  # [B,D,H,W,3]

        pooled = avg_pool_nhwc(vol.abs(), self._pool_window())
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
        self.last_grid = (d2, h2, w2)
        self.in_fpn_feat = curr if self.keep_features else None

        # positional coordinates in (D, H, W) order (:442-470)
        scale_d, scale_h, scale_w = d // d2, h // h2, w // w2
        assert scale_d * d2 == d and scale_h * h2 == h and scale_w * w2 == w, \
            "the volume must be divisible by the FPN grid"
        sh, sw, sd = self.input_scale
        zyx = gen_all_indices((d2, h2, w2), device=batch.device)
        zyx = zyx.reshape(-1, 3).float() * torch.tensor(
            [[scale_d / sd, scale_h / sh, scale_w / sw]], dtype=torch.float32,
            device=batch.device)
        voxels_pos = zyx[None].expand(b, n, 3)

        enc_args = (vfeat_fpn, voxels_pos, vmask.reshape(b, n)[..., None],
                    (d2, h2, w2))
        vfeat_fused = (remat(self.voxel_fusion, *enc_args) if rematted
                       else self.voxel_fusion(*enc_args))
        vfeat_fused = vfeat_fused.reshape(b, d2, h2, w2, cfg.trans_out_dim)

        if not self.do_out_fpn:
            # the 1x1 head on the fused grid (segtran3d.py:221-223 of JAX)
            scores = apply_pointwise(vfeat_fused.permute(0, 2, 3, 1, 4),
                                     *self.out_conv3d.matrix())
            return resize_linear(scores.float(), (h, w, d))

        curr = feats[cfg.out_fpn_layers[0]]
        for layer in self.extra_layers:
            curr = self._fpn_step(f"out_fpn{layer}{layer + 1}_conv3d",
                                  f"out_gn{layer + 1}b", curr,
                                  feats[layer + 1], cfg.out_fpn_scheme, dt)
        if (cfg.out_fpn_do_dropout and self.training
                and cfg.hidden_dropout_prob > 0):
            scores = self._unfactored_tail(curr, vfeat_fused)
        else:
            scores = self._factored_tail(curr, vfeat_fused)
        return resize_linear(scores.float(), (h, w, d))

    def _factored_tail(self, curr, vfeat_fused):
        """The linear tail reassociated (nn/heads.py): [B, D', H', W', D']
        -> depth-last scores [B, H', W', D'', num_classes]."""
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
        bb, dd, hh, ww, _ = scores.shape
        if self.fold:
            # channels (kk, cls) -> depth kk*D + d (segtran3d.py:376-379)
            scores = scores.reshape(bb, dd, hh, ww, k, cfg.num_classes)
            scores = scores.permute(0, 4, 1, 2, 3, 5).reshape(
                bb, k * dd, hh, ww, cfg.num_classes)
        elif k > 1 and cfg.out_fpn_upsampleD_scheme == "interp":
            scores = resize_linear(scores, (dd * k, hh, ww))
        return scores.permute(0, 2, 3, 1, 4)            # depth last

    def _unfactored_tail(self, curr, vfeat_fused):
        """The tail in the reference's order (JAX segtran3d.py:188-220):
        bridge conv + the upsampled fused features, the depth unpool,
        dropout, depth last, out_conv3d."""
        cfg, k = self.cfg, self.cfg.D_pool_K
        out_feat = (apply_pointwise(curr, *self.out_fpn_bridgeconv3d.matrix())
                    + resize_linear(vfeat_fused, curr.shape[1:-1]))
        if self.fold:
            ups = apply_pointwise(out_feat, *self.out_fpn_upsampleD.matrix())
            bb, dd, hh, ww, _ = ups.shape
            # channel f*K + kk -> (f, kk); depth (kk, d) -> kk*D + d, the
            # reference's block order (segtran3d.py:376-379)
            out_feat = ups.reshape(bb, dd, hh, ww, -1, k).permute(
                0, 5, 1, 2, 3, 4).reshape(bb, k * dd, hh, ww, -1)
        elif k > 1 and cfg.out_fpn_upsampleD_scheme == "interp":
            dd, hh, ww = out_feat.shape[1:4]
            out_feat = resize_linear(out_feat, (dd * k, hh, ww))
        out_feat = self.out_fpn_dropout(out_feat).permute(0, 2, 3, 1, 4)
        return apply_pointwise(out_feat, *self.out_conv3d.matrix())


def init_segtran3d(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random init with the JAX package's initializer families
    (see init_segtran2d)."""
    return init_segtran2d(model, seed)
