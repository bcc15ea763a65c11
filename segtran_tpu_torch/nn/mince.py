"""The mince transformer: channel-partitioned multi-scale attention
(``--mince``). Counterpart of ``segtran_tpu/nn/mince.py`` (reference
CrossMinceAttFeatTrans, segtran_shared.py:612-785; helpers
resize_flat_features :47-66, fracs_to_indices :68-87):

* Q and K projected once; each mode's channels split equally across the
  scales, each scale's Q and K resized to 1/scale of the token grid;
* per scale: scores in fp32 scaled by 1/sqrt(the full mode dim), the
  global clamp, an optional position bias, softmax, dropout;
* V's channels split by ``mince_channel_props``; each scale's V resized
  down, contracted with its probs, resized back; the scales concatenated
  along the channels, then the expansion block's FFN (or aggregate) path.

It never takes the flash path: JAX's mince layer has no fused branch.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.resize import resize_linear
from .attention import (CrossAttFeatTrans, ExpandedFeatTrans,
                        TransLayerSpec, _clamp_if_exceeds)


def fracs_to_indices(feat_dim: int, props: Sequence[float]) -> List[int]:
    """Channel boundaries of ``props`` (normalised) over ``feat_dim``; the
    last part takes the remainder."""
    fr = np.asarray(props, dtype=float)
    fr = fr / fr.sum()
    idx = [0] * (len(fr) + 1)
    for i in range(len(fr) - 1):
        idx[i + 1] = idx[i] + int(fr[i] * feat_dim)
    idx[-1] = feat_dim
    return idx


def scaled_shape(geoshape: Sequence[int], scale: float) -> Tuple[int, ...]:
    """reference multi_resize_shape (:38-43): int(s / scale)."""
    return tuple(int(s / scale) for s in geoshape)


def resize_flat_features(x: torch.Tensor, geoshape: Sequence[int],
                         new_geoshape: Sequence[int]) -> torch.Tensor:
    """x [B, M, N, C], tokens in raster order over ``geoshape`` -> the same
    over ``new_geoshape`` (bilinear / trilinear, half-pixel centres)."""
    b, m, n, c = x.shape
    sp = tuple(int(s) for s in geoshape)
    assert math.prod(sp) == n, (sp, n)
    vol = x.permute(0, 2, 1, 3).reshape((b,) + sp + (m * c,))
    vol = resize_linear(vol, new_geoshape)
    n2 = math.prod(int(s) for s in new_geoshape)
    return vol.reshape(b, n2, m, c).permute(0, 2, 1, 3)


class CrossMinceAttFeatTrans(CrossAttFeatTrans):
    """Multi-scale attention layer; the Q/K projections and the expansion
    block are CrossAttFeatTrans's (so the reference init passes reach
    them), the forward is the mince one. ``keep_attn_scores`` keeps each
    scale's scores in ``attention_scores_per_scale`` (JAX sows them as
    ``attention_scores_{i}``, which the consistency loss does not read)."""

    def __init__(self, spec: TransLayerSpec,
                 mince_scales: Sequence[int] = (2, 1),
                 mince_channel_props: Sequence[float] = (1.0, 1.0),
                 keep_attn_scores: bool = False):
        super().__init__(spec, keep_attn_scores)
        if spec.ablate_multihead:
            self.out_trans = ExpandedFeatTrans(spec)
        self.mince_scales = tuple(mince_scales)
        self.mince_channel_props = tuple(mince_channel_props)
        self.attention_scores_per_scale = None

    def forward(self, in_query, query_geoshape, in_key=None,
                key_geoshape=None,
                pos_biases: Optional[List[Optional[torch.Tensor]]] = None):
        s = self.spec
        dt = s.dtype
        if in_key is None:
            in_key, key_geoshape = in_query, query_geoshape
        b, u1, _ = in_query.shape
        u2 = in_key.shape[1]
        m, amd = s.num_modes, s.attention_mode_dim
        qk_idx = fracs_to_indices(amd, [1.0] * len(self.mince_scales))
        q = self.query(in_query, dt).reshape(b, u1, m, amd).permute(0, 2, 1, 3)
        k = self._key()(in_key, dt).reshape(b, u2, m, amd).permute(0, 2, 1, 3)
        kept, scales_probs = [], []
        for si, scale in enumerate(self.mince_scales):
            q_s = q[..., qk_idx[si]:qk_idx[si + 1]]
            k_s = k[..., qk_idx[si]:qk_idx[si + 1]]
            if scale != 1:
                q_s = resize_flat_features(
                    q_s, query_geoshape, scaled_shape(query_geoshape, scale))
                k_s = resize_flat_features(
                    k_s, key_geoshape, scaled_shape(key_geoshape, scale))
            scores = torch.matmul(q_s.float(), k_s.float().transpose(-1, -2))
            scores = _clamp_if_exceeds(scores / math.sqrt(amd), s.attn_clip)
            if pos_biases is not None and pos_biases[si] is not None:
                scores = scores + s.pos_code_weight * pos_biases[si]
            kept.append(scores)
            probs = torch.softmax(scores, dim=-1).to(dt)
            scales_probs.append(self.attn_dropout(probs))
        self.attention_scores_per_scale = kept if self.keep_attn_scores \
            else None

        v = self.out_trans.compute_v(in_key)                 # [B, M, U2, F]
        v_idx = fracs_to_indices(s.feat_dim, self.mince_channel_props)
        fused_scales = []
        for si, scale in enumerate(self.mince_scales):
            v_s = v[..., v_idx[si]:v_idx[si + 1]]
            if scale != 1:
                v_s = resize_flat_features(v_s, key_geoshape,
                                           scaled_shape(key_geoshape, scale))
            fused = torch.matmul(scales_probs[si], v_s.to(dt))
            if scale != 1:
                fused = resize_flat_features(
                    fused, scaled_shape(query_geoshape, scale),
                    query_geoshape)
            fused_scales.append(fused)
        return self.out_trans(in_key, fused=torch.cat(fused_scales, dim=-1))
