"""Expert parallelism over Segtran's attention modes (counterpart of
``segtran_tpu/parallel/expert.py``).

Segtran's experts are its modes: the private per-mode FFN
(``MMPrivateLinear``, weight [M, F, F], bias [M, F]) computes independent
per-mode features that ``LearnedSoftAggregate`` softmax-pools over the
mode axis. With the modes sharded over a group each rank keeps and
computes its own modes and the pool is one distributed softmax: an
all-reduce MAX of the mode-axis maximum, an all-reduce SUM of the
denominator and one of the pooled part. ``train2d --tp N --ep`` shards the
private weights' state by whole modes (``tensor_parallel``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.norm import all_reduce_sum


def mode_sharded_ffn_aggregate(x: torch.Tensor, kernel: torch.Tensor,
                               bias: torch.Tensor, score_kernel: torch.Tensor,
                               score_bias: torch.Tensor, group=None
                               ) -> torch.Tensor:
    """softmax-aggregate(private_ffn(x)) with the mode axis sharded over
    ``group``: this rank's modes in, the pooled features of all modes out.

    x [B, M_local, U, F]: this rank's modes of the per-mode features;
    kernel [M_local, F, F] (in, out) / bias [M_local, F]: their
    ``MMPrivateLinear`` weights; score_kernel [F, 1] / score_bias [1]: the
    aggregate's feat2score, in JAX's (in, out) layout (the transpose of
    ``nn.Linear.weight``), the same on every rank. Returns [B, U, F],
    the same on every rank -- MMPrivateMid + LearnedSoftAggregate
    (group_dim=1) in eval mode. Differentiable (the max is a constant
    shift)."""
    y = torch.einsum("bmuf,mfg->bmug", x, kernel)
    y = F.gelu(y + bias[None, :, None, :], approximate="none")
    scores = torch.einsum("bmuf,fo->bmuo", y, score_kernel) + score_bias
    gmax = scores.detach().amax(1, keepdim=True)
    if group is not None:
        dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    p = torch.exp(scores - gmax)
    parts = torch.cat([p.sum(1, keepdim=True),
                       torch.sum(y * p, 1, keepdim=True)], -1)
    if group is not None:
        parts = all_reduce_sum(parts, group)
    denom, pooled = parts[..., :1], parts[..., 1:]
    return (pooled / denom)[:, 0]
