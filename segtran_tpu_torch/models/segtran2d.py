"""Segtran2d: EfficientNet, EfficientNetV2 or ResNet backbone -> input
FPN -> fusion transformer -> factored output-FPN tail (or, with
``out_fpn_layers == in_fpn_layers``, a 1x1 head or a 2x2 stride-2
transposed-conv head on the fused grid) -> bilinear resize. The FPNs normalise with GroupNorm or, with
``in_fpn_use_bn`` / ``out_fpn_use_bn``, BatchNorm (momentum 0.9, eps
1e-5; ``in_bn{l}b`` / ``out_bn{l}b``). ``num_modalities > 0`` takes
[B, H, W, C, MOD] inputs: the modality folds into the batch, and is
max-fused after the in-FPN and over the pyramid. ``use_global_bias``
replaces the fusion transformer with a learned, LayerNormed
``vfeat_bias``.

``model.train()`` gives the training forward (JAX ``train=True``): the
backbone's BatchNorm on batch statistics and its drop-connect, dropout at
the encoder's JAX sites, and, with ``out_fpn_do_dropout``, the unfactored
out-FPN tail with dropout before ``out_conv``. ``cfg.remat`` recomputes the
backbone and the encoder in the backward, ``cfg.remat_blocks`` each
backbone block (``nn/remat.py``).

Each forward records its token grid ``(h2, w2)`` in ``token_grid``. With
``keep_features`` it also keeps the input FPN's output ``in_fpn_feat``
[B, h2, w2, C] and, unless ``cfg.remat`` (JAX sows the layer outputs only
without it), each translayer's output tokens (``nn/features.py``);
``last_layer_feat`` is the last of them on the token grid: the features
the DA losses read (JAX train2d's ``_da_feature``).

Counterpart of ``segtran_tpu/models/segtran2d.py`` (reference
code/networks/segtran2d.py: forward :314-438, in_fpn_forward :235-271,
out_fpn_forward :273-312, get_mask :229-233). Module names follow the
reference attributes (backbone, in_fpn34_conv, in_gn4b, voxel_fusion,
out_fpn12_conv, out_gn2b, out_fpn_bridgeconv, out_conv), so the port's
state_dict keys are the reference's.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import Segtran2dConfig
from ..nn.attention import Dropout
from ..nn.backbones.efficientnet import EfficientNetFeatures
from ..nn.backbones.efficientnetv2 import EfficientNetV2Features
from ..nn.backbones.resnet import ResNetFeatures
from ..nn.encoder import SegtranFusionEncoder
from ..nn.heads import Conv1x1Params, apply_pointwise, compose_1x1
from ..nn.poscode import gen_all_indices
from ..nn.remat import remat
from ..ops.norm import BatchNorm, LayerNorm
from ..ops.resize import avg_pool_nhwc, resize_linear


class _GroupNorm(nn.GroupNorm):
    """flax nn.GroupNorm math on channels-last tensors: statistics and
    normalize in fp32 (fp64 for fp64 inputs), result in the compute dtype
    (eps 1e-5, segtran2d.py:148-150)."""

    def run(self, x, dtype):
        ct = torch.promote_types(x.dtype, torch.float32)
        y = F.group_norm(x.movedim(-1, 1).to(ct), self.num_groups,
                         self.weight.to(ct), self.bias.to(ct), self.eps)
        return y.movedim(1, -1).to(dtype)


class _BatchNorm(BatchNorm):
    """``ops.norm.BatchNorm`` (flax ``nn.BatchNorm(momentum=0.9,
    epsilon=1e-5, dtype)``, JAX segtran2d.py:35-38) on channels-last
    tensors."""

    def run(self, x, dtype):
        return self(x.movedim(-1, 1), dtype).movedim(1, -1)


def _conv1x1(x, conv: nn.Module, dtype):
    """1x1 (1x1x1) conv with bias on channels-last x as a pointwise
    product, in dtype."""
    w = conv.weight.reshape(conv.weight.shape[:2]).t()
    return apply_pointwise(x.to(dtype), w, conv.bias)


def make_backbone(cfg, in_channels: int = 3) -> nn.Module:
    """The backbone of ``cfg.backbone_type`` (JAX ``Segtran2d._backbone``):
    EfficientNet (stem stride 1 under ``bb_feat_upsize``), EfficientNetV2
    (likewise) or ResNet (``bb_feat_upsize`` drops the stem's max pool)."""
    bb, up = cfg.backbone_type, cfg.bb_feat_upsize
    if bb.startswith("eff-"):
        return EfficientNetFeatures(bb, stem_stride=1 if up else 2,
                                    in_channels=in_channels,
                                    remat_blocks=cfg.remat_blocks,
                                    dtype=cfg.dtype)
    if bb.startswith("effv2"):
        return EfficientNetV2Features(bb, stem_stride=1 if up else 2,
                                      in_channels=in_channels,
                                      dtype=cfg.dtype)
    if bb.startswith("resnet"):
        return ResNetFeatures(bb, do_pool1=not up, in_channels=in_channels,
                              dtype=cfg.dtype)
    raise ValueError(f"unknown backbone {bb}")


class Segtran2d(nn.Module):
    """``patch_size`` (H, W) of the model's input: needed only by the
    ``rand`` position code, whose table has one row per token."""

    def __init__(self, cfg: Segtran2dConfig,
                 patch_size: Optional[Sequence[int]] = None):
        super().__init__()
        self.cfg = cfg
        dims = cfg.bb_feat_dims
        self.backbone = make_backbone(cfg)
        for layer in cfg.in_fpn_layers[:-1]:
            self._add_fpn_level("in", layer)
        if dims[cfg.in_fpn_layers[-1]] != cfg.trans_in_dim:
            self.in_fpn_bridgeconv = nn.Conv2d(dims[cfg.in_fpn_layers[-1]],
                                               cfg.trans_in_dim, 1)
        if cfg.use_global_bias:
            # learned global bias ablation (reference segtran2d.py:79-85)
            self.vfeat_bias = nn.Parameter(
                torch.empty(1, 1, cfg.trans_out_dim))
            self.vfeat_bias_norm_layer = LayerNorm(cfg.trans_out_dim, 1e-5)
        else:
            grid = None
            if cfg.pos_code_type == "rand":
                if patch_size is None:
                    raise ValueError("the rand position code needs the "
                                     "model's patch_size")
                stride = self._grid_stride()
                grid = tuple(int(s) // stride for s in patch_size)
            self.voxel_fusion = SegtranFusionEncoder(cfg, token_grid=grid)
        self.do_out_fpn = cfg.out_fpn_layers != cfg.in_fpn_layers
        self.extra_layers = (cfg.out_fpn_layers[:-len(cfg.in_fpn_layers)]
                             if self.do_out_fpn else ())
        for layer in self.extra_layers:
            self._add_fpn_level("out", layer)
        if self.do_out_fpn:
            last_out_layer = cfg.out_fpn_layers[-len(cfg.in_fpn_layers)]
            if dims[last_out_layer] != cfg.trans_out_dim:
                self.out_fpn_bridgeconv = Conv1x1Params(dims[last_out_layer],
                                                        cfg.trans_out_dim)
            self.out_conv = Conv1x1Params(cfg.trans_out_dim, cfg.num_classes)
        elif 2 in cfg.in_fpn_layers:
            self.out_conv = nn.Conv2d(cfg.trans_out_dim, cfg.num_classes, 1)
        else:
            # 1/8-resolution features: a learned 2x upsampling head
            # (reference segtran2d.py:205-208)
            self.out_conv = nn.ConvTranspose2d(cfg.trans_out_dim,
                                               cfg.num_classes, 2, stride=2)
        self.out_fpn_dropout = Dropout(cfg.hidden_dropout_prob)
        self.keep_features = False
        self.token_grid = self.in_fpn_feat = None

    @property
    def last_layer_feat(self):
        """The last translayer's kept tokens on the token grid
        [B, h2, w2, C] (a view), or None."""
        outs = getattr(getattr(self, "voxel_fusion", None), "layer_outputs",
                       None)
        if not outs:
            return None
        return outs[-1].reshape(outs[-1].shape[0], *self.token_grid, -1)

    def _norm_name(self, prefix: str, layer: int) -> str:
        use_bn = (self.cfg.in_fpn_use_bn if prefix == "in"
                  else self.cfg.out_fpn_use_bn)
        return f"{prefix}_{'bn' if use_bn else 'gn'}{layer + 1}b"

    def _add_fpn_level(self, prefix: str, layer: int) -> None:
        """The 1x1 conv from level ``layer`` to ``layer + 1`` and its norm
        (reference segtran2d.py:103-106, 166-169)."""
        dims = self.cfg.bb_feat_dims
        setattr(self, f"{prefix}_fpn{layer}{layer + 1}_conv",
                nn.Conv2d(dims[layer], dims[layer + 1], 1))
        name = self._norm_name(prefix, layer)
        setattr(self, name, _BatchNorm(dims[layer + 1]) if "_bn" in name
                else _GroupNorm(self.cfg.G, dims[layer + 1], eps=1e-5))

    def _grid_stride(self) -> int:
        """Input pixels per token along each axis (the in-FPN's lowest
        layer, as the nonzero mask pools)."""
        stride = 2 ** min(self.cfg.in_fpn_layers)
        return stride if self.cfg.bb_feat_upsize else 2 * stride

    def _fpn_step(self, prefix, layer, curr, feats, scheme, dt):
        upconv = _conv1x1(curr, getattr(self, f"{prefix}_fpn{layer}{layer + 1}_conv"), dt)
        higher = resize_linear(feats[layer + 1], upconv.shape[1:-1])
        norm = getattr(self, self._norm_name(prefix, layer))
        if scheme == "AN":
            return norm.run(upconv + higher, dt)
        return norm.run(upconv, dt) + higher

    def forward(self, batch: torch.Tensor) -> torch.Tensor:
        """batch [B, H, W, C] (or [B, H, W, C, MOD] with num_modalities) ->
        logits [B, H, W, num_classes] (fp32)."""
        cfg = self.cfg
        dt = cfg.dtype
        if cfg.num_modalities > 0:
            # modality folded into the batch (reference segtran2d.py:321-328)
            b0, h, w, c, mod = batch.shape
            batch = batch.permute(0, 4, 1, 2, 3).reshape(b0 * mod, h, w, c)
        else:
            b0, mod = batch.shape[0], 0
        b, h, w, _ = batch.shape

        # nonzero mask: AvgPool(|x|) summed over channels > 0
        pool_stride = self._grid_stride()
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
        self.token_grid = (h2, w2)
        self.in_fpn_feat = curr if self.keep_features else None
        vfeat_fpn = curr.reshape(b, h2 * w2, cfg.trans_in_dim)
        vmask = nonzero_mask.reshape(b, h2 * w2)
        if mod:
            # max-fuse the modalities after the in-FPN (segtran2d.py:361-368)
            vfeat_fpn = vfeat_fpn.reshape(b0, mod, h2 * w2, -1).amax(1)
            vmask = vmask.reshape(b0, mod, h2 * w2)[:, 0]

        # positional coordinates (segtran2d.py:372-392)
        scale_h, scale_w = h // h2, w // w2
        assert scale_h * h2 == h and scale_w * w2 == w, \
            "input size must be divisible by the FPN grid"
        xy = gen_all_indices((h2, w2), device=batch.device).reshape(-1, 2).float()
        xy = xy * torch.tensor([[scale_h, scale_w]], dtype=torch.float32,
                               device=batch.device)
        voxels_pos = xy[None].expand(b0, h2 * w2, 2)

        if cfg.use_global_bias:
            vfeat_fused = self.vfeat_bias_norm_layer(self.vfeat_bias).to(
                dt).expand(b0, h2 * w2, -1)
        else:
            self.voxel_fusion.keep_layer_outputs = (self.keep_features
                                                    and not cfg.remat)
            enc_args = (vfeat_fpn, voxels_pos, vmask[..., None].to(dt),
                        (h2, w2))
            vfeat_fused = (remat(self.voxel_fusion, *enc_args) if rematted
                           else self.voxel_fusion(*enc_args))
        vfeat_fused = vfeat_fused.reshape(b0, h2, w2, cfg.trans_out_dim)

        if mod:
            # the pyramid max-fused over the modalities too (JAX
            # segtran2d.py:151-158)
            feats = tuple(f.reshape((b0, mod) + f.shape[1:]).amax(1)
                          for f in feats)
        if not self.do_out_fpn:
            if isinstance(self.out_conv, nn.ConvTranspose2d):
                scores = F.conv_transpose2d(
                    vfeat_fused.movedim(-1, 1), self.out_conv.weight.to(dt),
                    self.out_conv.bias.to(dt), stride=2).movedim(1, -1)
            else:
                scores = _conv1x1(vfeat_fused, self.out_conv, dt)
            return resize_linear(scores.float(), (h, w))

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
    the rand position table and the global bias, zeros for the sliding
    position biases, lecun-normal for 2-D and 3-D convs, ones/zeros for norm
    scales and biases. Segtran3d uses it too (``init_segtran3d``)."""
    gen = torch.Generator().manual_seed(seed)
    transposed = {id(m.weight) for m in model.modules()
                  if isinstance(m, nn.ConvTranspose2d)}
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("attractors", "pos_embed", "vfeat_bias"):
                p.normal_(0.0, 1.0, generator=gen)
            elif leaf in ("bias", "biases"):
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            elif p.dim() >= 4:
                # fan-in: in-channels x kernel ([I, O, kh, kw] when
                # transposed, else [O, I, kh, kw])
                fan_in = (p.shape[0] * p[0, 0].numel() if id(p) in transposed
                          else p[0].numel())
                p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)
            else:
                p.normal_(0.0, 0.02, generator=gen)
    return model
