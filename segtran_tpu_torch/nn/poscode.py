"""Positional codes for the fusion transformer: ``lsinu`` and ``none``.

Counterpart of ``segtran_tpu/nn/poscode.py`` (reference
segtran_shared.py:979-998, :1177-1238). The other codes (rand, sinu, bias)
belong to a later slice of the port.
"""
from __future__ import annotations

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


class SegtranPosEncoder(nn.Module):
    """Coordinate normalization by the global max, then the code
    (reference segtran_shared.py:1177-1238)."""

    def __init__(self, pos_code_type: str, pos_dim: int, pos_embed_dim: int,
                 ln_eps: float = 1e-12, dtype=torch.float32):
        super().__init__()
        if pos_code_type not in ("lsinu", "none"):
            raise NotImplementedError(
                f"pos code '{pos_code_type}' belongs to a later slice of the "
                f"port (this slice has lsinu and none)")
        self.pos_code_type = pos_code_type
        self.pos_embed_dim, self.dtype = pos_embed_dim, dtype
        if pos_code_type == "lsinu":
            self.pos_coder = LearnedSinuPosEmbedder(
                pos_dim, pos_embed_dim, omega=1.0, ln_eps=ln_eps, dtype=dtype)

    def forward(self, spatial_shape: Sequence[int],
                voxels_pos: torch.Tensor) -> torch.Tensor:
        if self.pos_code_type == "none":
            b, n = voxels_pos.shape[:2]
            return torch.zeros((b, n, self.pos_embed_dim), dtype=self.dtype,
                               device=voxels_pos.device)
        return self.pos_coder(voxels_pos / voxels_pos.max())


def gen_all_indices(spatial_shape: Sequence[int], device=None) -> torch.Tensor:
    """Coordinate grid [*spatial_shape, d] (reference
    segtran_shared.py:28-36)."""
    grids = torch.meshgrid(*[torch.arange(s, device=device)
                             for s in spatial_shape], indexing="ij")
    return torch.stack(grids, dim=-1)
