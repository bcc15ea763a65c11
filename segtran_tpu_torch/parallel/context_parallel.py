"""Context (token) parallelism for the squeezed transformer (counterpart of
``segtran_tpu/parallel/context_parallel.py``).

In the squeeze step (attractors <- tokens) the softmax runs over the
tokens, so with the tokens sharded over a group the attention is exact
by a distributed softmax. Each rank runs the port's flash forward
(``kernels/squeezed_attention.fused_cross_attention``: the CUDA kernel on
the card, its plain version for CPU tensors) on its keys, which gives its
output and the fp32 log-sum-exp of its clipped scores; the ranks' results
merge by their lse: L = log sum_r exp(lse_r) (an all-reduce MAX, then a
SUM, in fp32) and out = sum_r exp(lse_r - L) out_r, summed in fp32 and
rounded once to v's dtype. The expand step (tokens <- attractors) is
parallel over the tokens with no collective: its softmax runs over the
replicated attractors. The plain flash version on the whole input is the
oracle (tests/test_torch_parallel_primitives.py).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from ..kernels.squeezed_attention import fused_cross_attention


def sharded_cross_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, group=None,
                            attn_clip: float = 500.0,
                            sm_scale: Optional[float] = None
                            ) -> torch.Tensor:
    """softmax(clip(q k^T * sm_scale, +-attn_clip)) v with the token axis
    of k and v sharded over ``group``: q [G, Q, D] the same on every rank
    (e.g. the attractors), k [G, N_r, D] / v [G, N_r, F] this rank's
    tokens. Returns [G, Q, F] in v's dtype, the same on every rank."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    out, lse = fused_cross_attention(q, k, v, attn_clip, sm_scale,
                                     return_lse=True)
    if group is None or dist.get_world_size(group) == 1:
        return out
    top = lse.clone()
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    w = torch.exp(lse - top)
    total = w.clone()
    dist.all_reduce(total, group=group)
    acc = out.float() * (w / total)
    dist.all_reduce(acc, group=group)
    return acc.to(v.dtype)


def token_sharded_expand_attention(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, group=None,
                                   attn_clip: float = 500.0,
                                   sm_scale: Optional[float] = None
                                   ) -> torch.Tensor:
    """The expand step: q [G, Q_r, D] this rank's tokens, k [G, A, D] / v
    [G, A, F] the attractors (the same on every rank); the softmax over
    the attractors is local, so there is no collective and the output
    [G, Q_r, F] stays token-sharded. ``group`` is taken for symmetry."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return fused_cross_attention(q, k, v, attn_clip, sm_scale)
