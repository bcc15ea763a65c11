"""The ViT encoder of the TransUNet baseline.

Counterpart of ``segtran_tpu/nn/vit.py`` (reference code/networks/
transunet/vit_seg_modeling.py:50-257): pre-norm blocks of multi-head
self-attention (flax ``MultiHeadDotProductAttention``: separate query, key,
value and out projections, queries scaled by head_dim^-1/2, softmax) and
an exact-GELU MLP, LayerNorm eps 1e-6, dropout 0.1 after the MLP's
activation and output; a final ``encoder_norm``. The attention is the
model's own, not a squeezed-attention path: plain matmuls and softmax.

Tokens [B, N, D] in the compute dtype. The projections are ``nn.Linear``
(the JAX DenseGeneral kernels [D, heads, head_dim] and [heads, head_dim,
D] become [heads * head_dim, D] and [D, heads * head_dim]).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norm import LayerNorm
from .attention import Dropout, dense


class MlpBlock(nn.Module):
    def __init__(self, dim, mlp_dim, dropout=0.1, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, dim)
        self.drop1, self.drop2 = Dropout(dropout), Dropout(dropout)

    def forward(self, x):
        x = self.drop1(F.gelu(dense(x, self.fc1, self.dtype)))
        return self.drop2(dense(x, self.fc2, self.dtype))


class SelfAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (no dropout on the weights)."""

    def __init__(self, dim, num_heads, dtype=torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, d = x.shape
        h, dt = self.num_heads, self.dtype
        split = lambda lin: dense(x, lin, dt).reshape(b, n, h, d // h)\
            .transpose(1, 2)
        q, k, v = split(self.query), split(self.key), split(self.value)
        q = q / torch.tensor((d // h) ** 0.5, dtype=dt)
        w = torch.softmax(q @ k.transpose(-1, -2), -1).to(dt)
        o = (w @ v).transpose(1, 2).reshape(b, n, d)
        return dense(o, self.out, dt)


class ViTBlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_dim, dropout=0.1,
                 dtype=torch.float32):
        super().__init__()
        self.attention_norm = LayerNorm(dim, 1e-6, dtype=dtype)
        self.attn = SelfAttention(dim, num_heads, dtype)
        self.ffn_norm = LayerNorm(dim, 1e-6, dtype=dtype)
        self.ffn = MlpBlock(dim, mlp_dim, dropout, dtype)

    def forward(self, x):
        x = x + self.attn(self.attention_norm(x))
        return x + self.ffn(self.ffn_norm(x))


class ViTEncoder(nn.Module):
    """Tokens [B, N, D] -> encoded tokens (after ``encoder_norm``)."""

    def __init__(self, dim=768, num_layers=12, num_heads=12, mlp_dim=3072,
                 dropout=0.1, dtype=torch.float32):
        super().__init__()
        self.block = nn.ModuleList(
            ViTBlock(dim, num_heads, mlp_dim, dropout, dtype)
            for _ in range(num_layers))
        self.encoder_norm = LayerNorm(dim, 1e-6, dtype=dtype)

    def forward(self, x):
        for blk in self.block:
            x = blk(x)
        return self.encoder_norm(x)
