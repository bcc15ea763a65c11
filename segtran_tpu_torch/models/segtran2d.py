"""Segtran2d: EfficientNet backbone -> input FPN -> squeezed fusion
transformer -> factored output-FPN tail -> bilinear resize.

``model.train()`` gives the training forward (JAX ``train=True``): the
backbone's BatchNorm on batch statistics and its drop-connect, dropout at
the encoder's JAX sites, and, with ``out_fpn_do_dropout``, the unfactored
out-FPN tail with dropout before ``out_conv``. ``cfg.remat`` recomputes the
backbone and the encoder in the backward, ``cfg.remat_blocks`` each
backbone block (``nn/remat.py``).

Counterpart of ``segtran_tpu/models/segtran2d.py`` (reference
code/networks/segtran2d.py: forward :314-438, in_fpn_forward :235-271,
out_fpn_forward :273-312, get_mask :229-233). Module names follow the
reference attributes (backbone, in_fpn34_conv, in_gn4b, voxel_fusion,
out_fpn12_conv, out_gn2b, out_fpn_bridgeconv, out_conv), so the port's
state_dict keys are the reference's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import Segtran2dConfig
from ..nn.attention import Dropout
from ..nn.backbones.efficientnet import EfficientNetFeatures
from ..nn.encoder import SegtranFusionEncoder
from ..nn.heads import Conv1x1Params, apply_pointwise, compose_1x1
from ..nn.poscode import gen_all_indices
from ..nn.remat import remat
from ..ops.resize import avg_pool_nhwc, resize_linear


class _GroupNorm(nn.GroupNorm):
    """flax nn.GroupNorm math on channels-last tensors: statistics and
    normalize in fp32, result in the compute dtype (eps 1e-5,
    segtran2d.py:148-150)."""

    def run(self, x, dtype):
        y = F.group_norm(x.movedim(-1, 1).float(), self.num_groups,
                         self.weight, self.bias, self.eps)
        return y.movedim(1, -1).to(dtype)


def _conv1x1(x, conv: nn.Module, dtype):
    """1x1 (1x1x1) conv with bias on channels-last x as a pointwise
    product, in dtype."""
    w = conv.weight.reshape(conv.weight.shape[:2]).t()
    return apply_pointwise(x.to(dtype), w, conv.bias)


class Segtran2d(nn.Module):
    def __init__(self, cfg: Segtran2dConfig):
        super().__init__()
        self.cfg = cfg
        if not cfg.backbone_type.startswith("eff-"):
            raise NotImplementedError(
                f"backbone {cfg.backbone_type} belongs to a later slice of "
                f"the port (this slice has the EfficientNet backbones)")
        if cfg.out_fpn_layers == cfg.in_fpn_layers:
            raise NotImplementedError(
                "the no-out-FPN head belongs to a later slice of the port")
        dims = cfg.bb_feat_dims
        self.backbone = EfficientNetFeatures(
            cfg.backbone_type, stem_stride=1 if cfg.bb_feat_upsize else 2,
            remat_blocks=cfg.remat_blocks, dtype=cfg.dtype)
        for layer in cfg.in_fpn_layers[:-1]:
            setattr(self, f"in_fpn{layer}{layer + 1}_conv",
                    nn.Conv2d(dims[layer], dims[layer + 1], 1))
            setattr(self, f"in_gn{layer + 1}b",
                    _GroupNorm(cfg.G, dims[layer + 1], eps=1e-5))
        if dims[cfg.in_fpn_layers[-1]] != cfg.trans_in_dim:
            self.in_fpn_bridgeconv = nn.Conv2d(dims[cfg.in_fpn_layers[-1]],
                                               cfg.trans_in_dim, 1)
        self.voxel_fusion = SegtranFusionEncoder(cfg)
        self.extra_layers = cfg.out_fpn_layers[:-len(cfg.in_fpn_layers)]
        for layer in self.extra_layers:
            setattr(self, f"out_fpn{layer}{layer + 1}_conv",
                    nn.Conv2d(dims[layer], dims[layer + 1], 1))
            setattr(self, f"out_gn{layer + 1}b",
                    _GroupNorm(cfg.G, dims[layer + 1], eps=1e-5))
        last_out_layer = cfg.out_fpn_layers[-len(cfg.in_fpn_layers)]
        if dims[last_out_layer] != cfg.trans_out_dim:
            self.out_fpn_bridgeconv = Conv1x1Params(dims[last_out_layer],
                                                    cfg.trans_out_dim)
        self.out_conv = Conv1x1Params(cfg.trans_out_dim, cfg.num_classes)
        self.out_fpn_dropout = Dropout(cfg.hidden_dropout_prob)

    def _fpn_step(self, prefix, layer, curr, feats, scheme, dt):
        upconv = _conv1x1(curr, getattr(self, f"{prefix}_fpn{layer}{layer + 1}_conv"), dt)
        higher = resize_linear(feats[layer + 1], upconv.shape[1:-1])
        norm = getattr(self, f"{prefix}_gn{layer + 1}b")
        if scheme == "AN":
            return norm.run(upconv + higher, dt)
        return norm.run(upconv, dt) + higher

    def forward(self, batch: torch.Tensor) -> torch.Tensor:
        """batch [B, H, W, C] -> logits [B, H, W, num_classes] (fp32)."""
        cfg = self.cfg
        dt = cfg.dtype
        b, h, w, _ = batch.shape

        # nonzero mask: AvgPool(|x|) summed over channels > 0
        pool_stride = 2 ** min(cfg.in_fpn_layers)
        if not cfg.bb_feat_upsize:
            pool_stride *= 2
        pooled = avg_pool_nhwc(batch.abs(), (pool_stride, pool_stride))
        nonzero_mask = pooled.sum(-1) > 0                    # [B, H2, W2]

        rematted = cfg.remat and self.training and torch.is_grad_enabled()
        feats = remat(self.backbone, batch) if rematted else self.backbone(batch)

        # input FPN
        curr = feats[cfg.in_fpn_layers[0]]
        for layer in cfg.in_fpn_layers[:-1]:
            curr = self._fpn_step("in", layer, curr, feats, cfg.in_fpn_scheme, dt)
        if hasattr(self, "in_fpn_bridgeconv"):
            curr = _conv1x1(curr, self.in_fpn_bridgeconv, dt)
        h2, w2 = curr.shape[1], curr.shape[2]
        vfeat_fpn = curr.reshape(b, h2 * w2, cfg.trans_in_dim)
        vmask = nonzero_mask.reshape(b, h2 * w2)

        # positional coordinates (segtran2d.py:372-392)
        scale_h, scale_w = h // h2, w // w2
        assert scale_h * h2 == h and scale_w * w2 == w, \
            "input size must be divisible by the FPN grid"
        xy = gen_all_indices((h2, w2), device=batch.device).reshape(-1, 2).float()
        xy = xy * torch.tensor([[scale_h, scale_w]], dtype=torch.float32,
                               device=batch.device)
        voxels_pos = xy[None].expand(b, h2 * w2, 2)

        enc_args = (vfeat_fpn, voxels_pos, vmask[..., None].to(dt), (h2, w2))
        vfeat_fused = (remat(self.voxel_fusion, *enc_args) if rematted
                       else self.voxel_fusion(*enc_args))
        vfeat_fused = vfeat_fused.reshape(b, h2, w2, cfg.trans_out_dim)

        curr = feats[cfg.out_fpn_layers[0]]
        for layer in self.extra_layers:
            curr = self._fpn_step("out", layer, curr, feats, cfg.out_fpn_scheme, dt)
        wo, bo = self.out_conv.matrix()
        if (cfg.out_fpn_do_dropout and self.training
                and cfg.hidden_dropout_prob > 0):
            # the unfactored tail (JAX segtran2d.py:206-214): bridge, add
            # the upsampled fused features, dropout, out_conv
            if hasattr(self, "out_fpn_bridgeconv"):
                curr = apply_pointwise(curr, *self.out_fpn_bridgeconv.matrix())
            out_feat = curr + resize_linear(vfeat_fused, curr.shape[1:3])
            scores = apply_pointwise(self.out_fpn_dropout(out_feat), wo, bo)
            return resize_linear(scores.float(), (h, w))
        # output FPN with the factored linear tail (segtran2d.py:184-205 of
        # the JAX package): bias in b1, none on the fused branch
        if hasattr(self, "out_fpn_bridgeconv"):
            wb, bb = self.out_fpn_bridgeconv.matrix()
            w1, b1 = compose_1x1(wb, bb, wo, bo)
        else:
            w1, b1 = wo, bo
        scores = apply_pointwise(curr, w1, b1)
        fused_cls = apply_pointwise(vfeat_fused, wo)
        scores = scores + resize_linear(fused_cls, curr.shape[1:3])
        return resize_linear(scores.float(), (h, w))


def init_segtran2d(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random init with the JAX package's initializer families:
    normal(0.02) for linear and private weights, normal(1) for attractors,
    lecun-normal for 2-D and 3-D convs, ones/zeros for norm scales and
    biases. Segtran3d uses it too (``init_segtran3d``)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "attractors":
                p.normal_(0.0, 1.0, generator=gen)
            elif leaf == "bias":
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            elif p.dim() >= 4:
                p.normal_(0.0, 1.0 / math.sqrt(p[0].numel()), generator=gen)
            else:
                p.normal_(0.0, 0.02, generator=gen)
    return model
