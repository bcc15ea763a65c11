"""Positional codes for the fusion transformer: ``lsinu``, ``rand``,
``sinu``, ``none`` and the sliding relative ``bias``.

Counterpart of ``segtran_tpu/nn/poscode.py`` (reference
segtran_shared.py:979-1238, segtran_ablation.py:13-76). The rand and sinu
tables are sized from the real token grid (the reference hard-codes
36x36); 3-D grids take an ``(n_tokens, 1)`` rand table and a 1-D sincos
over the flattened token index. ``bias`` gives the ``[1, 1, N, N]`` matrix
added to the attention scores: ``biases[k - q + R]`` within the
``(2R+1)^d`` window, else 0.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..ops.norm import layer_norm


class LearnedSinuPosEmbedder(nn.Module):
    """Continuous learnable sinusoidal code over normalized coordinates
    (reference segtran_shared.py:979-998)."""

    def __init__(self, pos_dim: int, pos_embed_dim: int, omega: float = 1.0,
                 ln_eps: float = 1e-12, dtype=torch.float32):
        super().__init__()
        self.pos_fc = nn.Linear(pos_dim, pos_embed_dim)
        self.omega, self.ln_eps, self.dtype = omega, ln_eps, dtype

    def forward(self, pos_normed: torch.Tensor) -> torch.Tensor:
        # [B, N, pos_dim] -> [B, N, pos_embed_dim]
        dt = self.dtype
        e = torch.matmul(pos_normed.to(dt), self.pos_fc.weight.to(dt).t()) \
            + self.pos_fc.bias.to(dt)
        sin_part = torch.sin(self.omega * e[..., 0::2])
        cos_part = torch.cos(self.omega * e[..., 1::2])
        # interlace: out[2i] = sin(e[2i]), out[2i+1] = cos(e[2i+1])
        mixed = torch.stack([sin_part, cos_part], dim=-1).reshape(e.shape)
        # pos_mix_norm_layer: non-affine LayerNorm
        return layer_norm(mixed, None, None, self.ln_eps, dt)


class RandPosEmbedder(nn.Module):
    """A learnable table of ``n_tokens`` embeddings (normal(1.0) init), then
    a LayerNorm without affine; ignores the coordinates (reference
    segtran_ablation.py:38-54)."""

    def __init__(self, n_tokens: int, pos_embed_dim: int,
                 ln_eps: float = 1e-12, dtype=torch.float32):
        super().__init__()
        self.pos_embed = nn.Parameter(torch.empty(n_tokens, pos_embed_dim))
        self.ln_eps, self.dtype = ln_eps, dtype

    def forward(self, pos_normed: torch.Tensor) -> torch.Tensor:
        normed = layer_norm(self.pos_embed, None, None, self.ln_eps,
                            self.dtype)
        return normed[None].expand(pos_normed.shape[0], -1, -1)


def fixed_positional_encoding_2d(pos_embed_dim: int, height: int, width: int,
                                 device=None) -> torch.Tensor:
    """The fixed 2-D sin/cos table (reference segtran_ablation.py:13-36):
    the first half of the channels codes the column, the second the row.
    Returns fp32 [height * width, pos_embed_dim]."""
    if pos_embed_dim % 4 != 0:
        raise ValueError("pos_embed_dim must be a multiple of 4")
    half = pos_embed_dim // 2
    f32 = dict(dtype=torch.float32, device=device)
    div_term = torch.exp(torch.arange(0.0, half, 2, **f32)
                         * (-math.log(10000.0) / half))
    pos_w = torch.arange(0.0, width, **f32)[:, None] * div_term[None]
    pos_h = torch.arange(0.0, height, **f32)[:, None] * div_term[None]
    pe = torch.zeros(height, width, pos_embed_dim, **f32)
    pe[:, :, 0:half:2] = torch.sin(pos_w)[None]
    pe[:, :, 1:half:2] = torch.cos(pos_w)[None]
    pe[:, :, half::2] = torch.sin(pos_h)[:, None]
    pe[:, :, half + 1::2] = torch.cos(pos_h)[:, None]
    return pe.reshape(height * width, pos_embed_dim)


class SinuPosEmbedder(nn.Module):
    """The fixed 2-D sinusoidal table of the token grid (reference
    segtran_ablation.py:56-67); no parameters."""

    def __init__(self, pos_embed_dim: int, dtype=torch.float32):
        super().__init__()
        self.pos_embed_dim, self.dtype = pos_embed_dim, dtype

    def forward(self, spatial_shape: Sequence[int],
                pos_normed: torch.Tensor) -> torch.Tensor:
        table = fixed_positional_encoding_2d(
            self.pos_embed_dim, *spatial_shape, device=pos_normed.device)
        return table[None].to(self.dtype).expand(pos_normed.shape[0], -1, -1)


def relative_bias_matrix(biases: torch.Tensor, spatial_shape: Sequence[int],
                         radius: int) -> torch.Tensor:
    """Expand a ``(2R+1)^d`` kernel into the dense [N, N] bias matrix:
    bias(q, k) = biases[k - q + R] where every |k_d - q_d| <= R, else 0
    (JAX ``_relative_bias_matrix``; reference segtran_shared.py:1051-1072,
    1152-1175)."""
    r, d = radius, len(spatial_shape)
    idx, valid = [], None
    for i, size in enumerate(spatial_shape):
        coords = torch.arange(size, device=biases.device)
        delta = coords[None, :] - coords[:, None]             # [q, k] = k - q
        shape = [1] * (2 * d)
        shape[2 * i] = shape[2 * i + 1] = size
        idx.append(torch.clamp(delta + r, 0, 2 * r).reshape(shape))
        v = (delta.abs() <= r).reshape(shape)
        valid = v if valid is None else valid & v
    bias_nd = biases[tuple(idx)] * valid.to(biases.dtype)
    # [s1, s1', s2, s2', ...] -> [s1, s2, ..., s1', s2', ...]
    perm = list(range(0, 2 * d, 2)) + list(range(1, 2 * d, 2))
    n = math.prod(int(s) for s in spatial_shape)
    return bias_nd.permute(perm).reshape(n, n)


class SlidingPosBiases(nn.Module):
    """Learnable relative bias within a ``(2R+1)^d`` window, zero init
    (reference SlidingPosBiases2D/3D, segtran_shared.py:1002-1175)."""

    def __init__(self, pos_dim: int, pos_bias_radius: int = 7,
                 dtype=torch.float32):
        super().__init__()
        self.radius, self.dtype = pos_bias_radius, dtype
        self.biases = nn.Parameter(
            torch.zeros((2 * pos_bias_radius + 1,) * pos_dim))

    def forward(self, spatial_shape: Sequence[int]) -> torch.Tensor:
        return relative_bias_matrix(self.biases.to(self.dtype),
                                    tuple(spatial_shape), self.radius)


class SegtranPosEncoder(nn.Module):
    """Coordinate normalization by the global max, then the code
    (reference segtran_shared.py:1177-1238). Embedding codes give [B, N,
    pos_embed_dim]; ``bias`` gives [1, 1, N, N]. ``rand`` needs the token
    grid (``spatial_shape``) at construction: its table has one row per
    token."""

    def __init__(self, pos_code_type: str, pos_dim: int, pos_embed_dim: int,
                 pos_bias_radius: int = 7, ln_eps: float = 1e-12,
                 dtype=torch.float32, spatial_shape: Sequence[int] = None):
        super().__init__()
        self.pos_code_type = pos_code_type
        self.pos_embed_dim, self.dtype = pos_embed_dim, dtype
        if pos_code_type == "lsinu":
            self.pos_coder = LearnedSinuPosEmbedder(
                pos_dim, pos_embed_dim, omega=1.0, ln_eps=ln_eps, dtype=dtype)
        elif pos_code_type == "rand":
            if spatial_shape is None:
                raise ValueError("the rand position code needs the token "
                                 "grid (spatial_shape)")
            self.pos_coder = RandPosEmbedder(
                math.prod(int(s) for s in spatial_shape), pos_embed_dim,
                ln_eps=ln_eps, dtype=dtype)
        elif pos_code_type == "sinu":
            self.pos_coder = SinuPosEmbedder(pos_embed_dim, dtype=dtype)
        elif pos_code_type == "bias":
            self.pos_coder = SlidingPosBiases(pos_dim, pos_bias_radius,
                                              dtype=dtype)
        elif pos_code_type != "none":
            raise ValueError(f"unknown pos_code_type {pos_code_type}")

    def forward(self, spatial_shape: Sequence[int],
                voxels_pos: torch.Tensor) -> torch.Tensor:
        kind = self.pos_code_type
        if kind == "none":
            b, n = voxels_pos.shape[:2]
            return torch.zeros((b, n, self.pos_embed_dim), dtype=self.dtype,
                               device=voxels_pos.device)
        if kind == "bias":
            biases = self.pos_coder(spatial_shape)
            return biases[None, None]
        if kind == "sinu" and len(spatial_shape) != 2:
            # 3-D grids: 1-D sincos over the flattened token index
            n = math.prod(int(s) for s in spatial_shape)
            half = self.pos_embed_dim // 2
            f32 = dict(dtype=torch.float32, device=voxels_pos.device)
            div = torch.exp(torch.arange(0.0, half, **f32)
                            * (-math.log(10000.0) / half))
            pos = torch.arange(0.0, n, **f32)[:, None] * div[None]
            table = torch.cat([torch.sin(pos), torch.cos(pos)], -1)
            return table[None].to(self.dtype).expand(voxels_pos.shape[0],
                                                     -1, -1)
        pos_normed = voxels_pos / voxels_pos.max()
        if kind == "sinu":
            return self.pos_coder(spatial_shape, pos_normed)
        return self.pos_coder(pos_normed)


def gen_all_indices(spatial_shape: Sequence[int], device=None) -> torch.Tensor:
    """Coordinate grid [*spatial_shape, d] (reference
    segtran_shared.py:28-36)."""
    grids = torch.meshgrid(*[torch.arange(s, device=device)
                             for s in spatial_shape], indexing="ij")
    return torch.stack(grids, dim=-1)
