"""SETR-PUP (``--net setr``): a ViT-Large encoder and the progressive-
upsampling head.

Counterpart of ``segtran_tpu/models/setr.py`` (the reference's vendored
mmseg ``EncoderDecoder(VisionTransformer, VisionTransformerUpHead)`` run
through ``forward_dummy``): a 16x16 patchify conv, the cls token in front,
learned position embeddings over N + 1 tokens, dropout, 24 pre-LN blocks
with a fused qkv projection (heads 16, scale head_dim^-1/2, the softmax in
fp32) and an exact-GELU MLP, no final encoder norm; the head drops the cls
token only when the token count is not a multiple of 48 (the reference's
quirk), applies LayerNorm eps 1e-6, then four conv3x3 + BN + ReLU with
bilinear (``align_corners=False``) 2x upsamples between, the 1x1
classifier and a last 2x upsample; the logits are resized to the input.
The input size is fixed at construction (one position row per patch).

NHWC in, fp32 NHWC logits out. Module names are the JAX scopes
(``backbone.blocks.3.attn.qkv``, ``decode_head.syncbn_fc_2``).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.attention import Dropout, dense
from ..nn.convbn import (BatchNorm, Conv2d, bn_relu, nchw, nhwc,
                         resize_nchw)
from ..ops.norm import LayerNorm


class SETRAttention(nn.Module):
    def __init__(self, dim, num_heads, dropout=0.1, dtype=torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.drop = Dropout(dropout)

    def forward(self, x):
        b, n, c = x.shape
        h, dt = self.num_heads, self.dtype
        qkv = dense(x, self.qkv, dt).reshape(b, n, 3, h, c // h)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        attn = (q @ k.transpose(-1, -2)) * ((c // h) ** -0.5)
        attn = torch.softmax(attn.float(), -1).to(dt)
        out = (attn @ v).transpose(1, 2).reshape(b, n, c)
        return self.drop(dense(out, self.proj, dt))


class SETRMlp(nn.Module):
    def __init__(self, dim, hidden, dropout=0.1, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.drop1, self.drop2 = Dropout(dropout), Dropout(dropout)

    def forward(self, x):
        x = self.drop1(F.gelu(dense(x, self.fc1, self.dtype)))
        return self.drop2(dense(x, self.fc2, self.dtype))


class SETRBlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=4.0, dropout=0.1,
                 dtype=torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, 1e-6, dtype=dtype)
        self.attn = SETRAttention(dim, num_heads, dropout, dtype)
        self.norm2 = LayerNorm(dim, 1e-6, dtype=dtype)
        self.mlp = SETRMlp(dim, int(dim * mlp_ratio), dropout, dtype)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class SETRBackbone(nn.Module):
    """x [B, C, H, W] -> (tokens [B, 1 + N, D] after the last block, the
    patch grid)."""

    def __init__(self, img_size: Sequence[int], patch=16, embed_dim=1024,
                 depth=24, num_heads=16, mlp_ratio=4.0, drop_rate=0.1,
                 in_channels=3, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.patch_embed = Conv2d(in_channels, embed_dim, patch, patch)
        n = (int(img_size[0]) // patch) * (int(img_size[1]) // patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, embed_dim))
        self.pos_drop = Dropout(drop_rate)
        self.blocks = nn.ModuleList(
            SETRBlock(embed_dim, num_heads, mlp_ratio, drop_rate, dtype)
            for _ in range(depth))

    def forward(self, x):
        dt = self.dtype
        x = self.patch_embed.run(x, dt)
        b, _, gh, gw = x.shape
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.to(dt).expand(b, -1, -1), x], 1)
        x = self.pos_drop(x + self.pos_embed.to(dt))
        for blk in self.blocks:
            x = blk(x)
        return x, (gh, gw)


class SETRUpHead(nn.Module):
    """The decode head: tokens [B, 1 + N or N, D] on a (gh, gw) grid ->
    logits [B, num_classes, 16 gh, 16 gw] (``num_conv`` 4, the
    progressive upsampling) or [B, num_classes, 4 gh, 4 gw] (``num_conv``
    2, the reference's auxiliary-head shape: one conv3x3 + BN + ReLU, a 4x
    upsample, the 1x1 classifier)."""

    def __init__(self, embed_dim, num_classes, dtype=torch.float32,
                 num_conv: int = 4):
        super().__init__()
        if num_conv not in (2, 4):
            raise ValueError(f"num_conv={num_conv} not in (2, 4)")
        self.dtype, self.num_conv = dtype, num_conv
        self.norm = LayerNorm(embed_dim, 1e-6, dtype=dtype)
        n_mid = {2: 1, 4: 4}[num_conv]        # conv3x3 + BN + ReLU stages
        cin = embed_dim
        for i in range(n_mid):
            setattr(self, f"conv_{i}", Conv2d(cin, 256, 3, padding=1))
            setattr(self, f"syncbn_fc_{i}", BatchNorm(256))
            cin = 256
        setattr(self, f"conv_{n_mid}", Conv2d(256, num_classes, 1))

    def forward(self, tokens, grid):
        dt = self.dtype
        gh, gw = grid
        if tokens.shape[1] % 48 != 0:
            tokens = tokens[:, 1:]
        x = self.norm(tokens)
        b, _, c = x.shape
        x = x.transpose(1, 2).reshape(b, c, gh, gw)
        if self.num_conv == 2:
            x = bn_relu(self.conv_0, self.syncbn_fc_0, x, dt)
            x = resize_nchw(x, (x.shape[2] * 4, x.shape[3] * 4))
            return self.conv_1.run(x, dt)
        for i in range(4):
            x = bn_relu(getattr(self, f"conv_{i}"),
                        getattr(self, f"syncbn_fc_{i}"), x, dt)
            if i < 3:
                x = resize_nchw(x, (x.shape[2] * 2, x.shape[3] * 2))
        x = self.conv_4.run(x, dt)
        return resize_nchw(x, (x.shape[2] * 2, x.shape[3] * 2))


class SETR_PUP(nn.Module):
    """The fundus recipe's ViT-Large by default (embed 1024, depth 24,
    heads 16, patch 16, dropout 0.1); ``img_size`` (H, W); ``num_conv``
    2 takes the auxiliary-head shape as the decode head (JAX
    ``SETR_PUP(num_conv=2)``; no CLI builds it)."""

    def __init__(self, num_classes: int = 3, img_size=(288, 288),
                 patch: int = 16, embed_dim: int = 1024, depth: int = 24,
                 num_heads: int = 16, mlp_ratio: float = 4.0,
                 drop_rate: float = 0.1, num_conv: int = 4,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.backbone = SETRBackbone(img_size, patch, embed_dim, depth,
                                     num_heads, mlp_ratio, drop_rate,
                                     dtype=dtype)
        self.decode_head = SETRUpHead(embed_dim, num_classes, dtype,
                                      num_conv)

    def forward(self, x):
        h, w = x.shape[1:3]
        tokens, grid = self.backbone(nchw(x, self.dtype))
        logits = self.decode_head(tokens, grid)
        return nhwc(resize_nchw(logits, (h, w)).float())
