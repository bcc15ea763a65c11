"""Pipeline parallelism: a GPipe schedule over the ranks of a group
(counterpart of ``segtran_tpu/parallel/pipeline.py``).

One stage per rank; the batch splits into M microbatches, and in each of
the M + S - 1 ticks rank i runs microbatch t - i (where it exists) and
hands its output to rank i + 1 with ``batch_isend_irecv`` (each tick's
sends and receives posted together, so gloo cannot deadlock). The last
stage's outputs are broadcast to every rank.

torch's point-to-point operations have no autograd, and a hand-off node
in the autograd graph would not run under ``torch.autograd.grad`` when it
leads to none of the requested inputs (a receive's backward, the send of
a gradient to the previous rank, would be pruned and its peer would wait
forever). So ``gpipe`` is one ``autograd.Function`` whose backward runs
the schedule in reverse: the cotangent of the broadcast output -- the
mean over the ranks of theirs, each rank computing the loss on its copy,
as data-parallel ranks average theirs -- enters the last stage, each
stage back-propagates its saved microbatch graphs and sends the input
gradients to the previous rank. ``torch.autograd.grad`` of a loss on
gpipe's output then gives each rank its own stage's parameter gradients,
and every rank the gradient of the input.

``make_translayer_stage`` is the fusion encoder's loop body (uniform
translayer dims); ``stack_translayer_params`` carries each rank its own
stage's state from a full encoder state_dict. For heterogeneous dims
(``--layercompress 1,1,2,2``) the hand-off rides zero-padded to the first
(largest) dim and ``make_hetero_translayer_stage`` builds the rank's own
stage at its true shapes (``stack_translayer_params_padded``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils._pytree import tree_flatten, tree_unflatten

from .mesh import group_rank


def _global(group, r):
    """The global rank of group rank ``r`` (None outside the group)."""
    if r < 0 or r >= group_rank(group)[1]:
        return None
    return r if group is None else dist.get_global_rank(group, r)


def _exchange(sends, send_to, recv_like, recv_from, group):
    """Post this tick's sends and receives together and wait; returns the
    received tensors (None without a receive)."""
    ops, got = [], None
    if sends is not None:
        ops += [dist.P2POp(dist.isend, t, send_to, group) for t in sends]
    if recv_like is not None:
        got = [torch.empty_like(t) for t in recv_like]
        ops += [dist.P2POp(dist.irecv, t, recv_from, group) for t in got]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return got


class _GPipe(torch.autograd.Function):

    @staticmethod
    def forward(ctx, stage_fn, p_spec, x_spec, n_params, group, m,
                *leaves):
        params, xs = list(leaves[:n_params]), list(leaves[n_params:])
        i, s = group_rank(group)
        prev, nxt = _global(group, i - 1), _global(group, i + 1)
        b = xs[0].shape[0]
        if b % m:
            raise ValueError(f"batch {b} not divisible by {m} microbatches")
        mb = b // m
        micro = [[x[k * mb:(k + 1) * mb] for x in xs] for k in range(m)]
        saved, bank, pending = {}, {}, None
        with torch.enable_grad():
            p_det = [p.detach().requires_grad_(p.requires_grad)
                     for p in params]
            p_tree = tree_unflatten(p_det, p_spec)
            for t in range(m + s - 1):
                k = t - i
                work = 0 <= k < m
                recv = _exchange(pending, nxt,
                                 micro[0] if (i > 0 and work) else None,
                                 prev, group)
                pending = None
                if not work:
                    continue
                inp = [a.detach().requires_grad_(a.is_floating_point())
                       for a in (micro[k] if i == 0 else recv)]
                out, _ = tree_flatten(stage_fn(p_tree,
                                               tree_unflatten(inp, x_spec)))
                saved[k] = (inp, out)
                if i < s - 1:
                    pending = [o.detach().contiguous() for o in out]
                else:
                    bank[k] = [o.detach() for o in out]
        if i == s - 1:
            y = [torch.cat([bank[k][j] for k in range(m)])
                 for j in range(len(xs))]
        else:
            y = [torch.empty_like(x) for x in xs]
        if s > 1:
            for t in y:
                dist.broadcast(t, _global(group, s - 1), group=group)
        ctx.stage = (p_det, saved, group, m, mb, len(xs))
        return tuple(y)

    @staticmethod
    def backward(ctx, *grad_y):
        p_det, saved, group, m, mb, n_x = ctx.stage
        i, s = group_rank(group)
        prev, nxt = _global(group, i - 1), _global(group, i + 1)
        gy = [g.contiguous().clone() for g in grad_y]
        if s > 1:
            for g in gy:
                dist.all_reduce(g, group=group)
                g.div_(s)
        p_grads: List = [None] * len(p_det)
        x_grads: Dict[int, List[torch.Tensor]] = {}
        pending = None
        for t in reversed(range(m + s - 1)):
            k = t - i
            work = 0 <= k < m
            recv = _exchange(pending, prev,
                             saved[k][1] if (i < s - 1 and work) else None,
                             nxt, group)
            pending = None
            if not work:
                continue
            inp, out = saved[k]
            if i == s - 1:
                gout = [g[k * mb:(k + 1) * mb] for g in gy]
            else:
                gout = recv
            pairs = [(o, g) for o, g in zip(out, gout) if o.requires_grad]
            want = [p for p in p_det if p.requires_grad] + \
                [a for a in inp if a.requires_grad]
            got = torch.autograd.grad([o for o, _ in pairs], want,
                                      [g for _, g in pairs],
                                      allow_unused=True) if pairs else \
                [None] * len(want)
            got = list(got)
            for j, p in enumerate(p_det):
                if p.requires_grad:
                    g = got.pop(0)
                    if g is not None:
                        p_grads[j] = g if p_grads[j] is None \
                            else p_grads[j] + g
            g_in = [got.pop(0) if a.requires_grad else None for a in inp]
            g_in = [torch.zeros_like(a) if g is None else g.contiguous()
                    for a, g in zip(inp, g_in)]
            if i > 0:
                pending = g_in
            else:
                x_grads[k] = g_in
        ctx.stage = None
        if i == 0:
            gx = [torch.cat([x_grads[k][j] for k in range(m)])
                  for j in range(n_x)]
        else:
            gx = [a.new_empty((m * mb,) + tuple(a.shape[1:]))
                  for a in saved[0][0]]
        if s > 1:
            for g in gx:
                dist.broadcast(g, _global(group, 0), group=group)
        return (None,) * 6 + tuple(p_grads) + tuple(gx)


def gpipe(stage_fn: Callable, stage_params, x, group=None,
          n_microbatches: int = 2):
    """Run one stage per rank of ``group``, GPipe-scheduled.

    ``stage_fn(params, x_mb) -> y_mb`` with y_mb of x_mb's structure and
    shapes (the homogeneous hand-off; constants such as position codes or
    masks pass through). ``stage_params``: this rank's stage's parameters
    (a dict or list of tensors). ``x``: a tensor or a tuple / list / dict
    of [B, ...] tensors, the same on every rank, B divisible by
    ``n_microbatches``. Returns the last stage's outputs on every rank,
    microbatch order kept. Differentiable (module docstring)."""
    p_leaves, p_spec = tree_flatten(stage_params)
    x_leaves, x_spec = tree_flatten(x)
    y = _GPipe.apply(stage_fn, p_spec, x_spec, len(p_leaves), group,
                     n_microbatches, *p_leaves, *x_leaves)
    return tree_unflatten(list(y), x_spec)


class _TranslayerStage(nn.Module):
    """One fusion-encoder layer as the encoder runs it (nn/encoder.py:
    affine LayerNorm -> + pos_code_weight * pos[..., :d_in] -> non-affine
    LayerNorm -> * mask -> translayer), in eval mode."""

    def __init__(self, cfg, i: int):
        super().__init__()
        from ..nn.attention import CrossAttFeatTrans, SqueezedAttFeatTrans
        from ..nn.encoder import layer_spec_from_config
        from ..ops.norm import LayerNorm
        dims = cfg.translayer_dims
        self.cfg, self.d_in = cfg, dims[i]
        self.vfeat_norm = LayerNorm(dims[i], cfg.ln_eps, dtype=cfg.dtype)
        self.comb_norm = LayerNorm(dims[i], cfg.ln_eps, affine=False,
                                   dtype=cfg.dtype)
        spec = layer_spec_from_config(cfg, i)
        self.translayer = (SqueezedAttFeatTrans(
            spec, num_attractors=cfg.num_attractors,
            has_FFN_in_squeeze=cfg.has_FFN_in_squeeze)
            if cfg.use_squeezed_transformer else CrossAttFeatTrans(spec))
        self.eval()

    def forward(self, vfeat, pos_code, vmask):
        feat = self.vfeat_norm(vfeat)
        if self.cfg.pos_code_type not in ("none", "bias"):
            feat = self.comb_norm(feat + self.cfg.pos_code_weight
                                  * pos_code[..., :self.d_in])
        return self.translayer(feat * vmask)


def _stage_fn(module: nn.Module, pad_to=None) -> Callable:
    def stage(p, xt):
        vfeat, pos_code, vmask = xt
        x = vfeat[..., :module.d_in] if pad_to else vfeat
        out = torch.func.functional_call(module, p, (x, pos_code, vmask))
        if pad_to:
            out = F.pad(out, (0, pad_to - out.shape[-1]))
        return out, pos_code, vmask
    return stage


def make_translayer_stage(cfg) -> Callable:
    """stage_fn(params, (vfeat, pos_code, vmask)) running one fusion-encoder
    layer, deterministic; params from ``stack_translayer_params``.
    Requires uniform translayer dims."""
    if len(set(cfg.translayer_dims)) != 1:
        raise ValueError(
            "pipeline stages must be homogeneous: use "
            f"translayer_compress_ratios of 1 (dims {cfg.translayer_dims})")
    return _stage_fn(_TranslayerStage(cfg, 0))


def _stage_state(encoder_sd: Dict[str, torch.Tensor], i: int):
    out = {}
    for k, v in encoder_sd.items():
        if k.startswith(f"vfeat_norm_layers.{i}."):
            out["vfeat_norm." + k.split(".", 2)[2]] = v
        elif k.startswith(f"translayers.{i}."):
            out["translayer." + k.split(".", 2)[2]] = v
    return out


def stack_translayer_params(encoder_sd: Dict[str, torch.Tensor],
                            num_layers: int, stage: int
                            ) -> Dict[str, torch.Tensor]:
    """Stage ``stage``'s parameters (its translayer and affine vfeat norm)
    from a full ``SegtranFusionEncoder`` state_dict, in
    ``make_translayer_stage``'s names. Every layer must have the same
    shapes (translayer_compress_ratios all 1)."""
    shapes = [{k: tuple(v.shape) for k, v in _stage_state(
        encoder_sd, i).items()} for i in range(num_layers)]
    if any(sh != shapes[0] for sh in shapes):
        raise ValueError("pipeline stages must be homogeneous: the "
                         "translayers' parameter shapes differ")
    return _stage_state(encoder_sd, stage)


def stack_translayer_params_padded(encoder_sd: Dict[str, torch.Tensor],
                                   num_layers: int, stage: int):
    """Heterogeneous dims (e.g. ``--layercompress 1,1,2,2``): stage
    ``stage``'s parameters at their true shapes, and every stage's
    {name: shape}. A rank needs only its own stage's shapes; the hand-off
    alone is padded (``make_hetero_translayer_stage``)."""
    shapes = [{k: tuple(v.shape) for k, v in _stage_state(
        encoder_sd, i).items()} for i in range(num_layers)]
    return _stage_state(encoder_sd, stage), shapes


def make_hetero_translayer_stage(cfg, stage_shapes: Sequence[dict],
                                 group=None) -> Callable:
    """stage_fn for gpipe over heterogeneous translayer dims: the hand-off
    rides zero-padded to the first (largest) dim; the rank's stage (its
    rank in ``group``) takes its d_in prefix, runs its layer at its true
    shapes and pads its output back, so the numerics are the sequential
    encoder's. The position code passes through at trans_in_dim and each
    stage reads its prefix, as the encoder does."""
    if cfg.pos_code_type == "bias":
        raise ValueError("pipeline stages do not serve 'bias' pos codes")
    dims = cfg.translayer_dims
    d_max = max(dims)
    if dims[0] != d_max:
        raise ValueError(
            f"expected non-increasing translayer dims, got {dims}")
    i, _ = group_rank(group)
    module = _TranslayerStage(cfg, i)
    got = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    if got != dict(stage_shapes[i]):
        raise ValueError(f"stage {i}'s parameter shapes do not match the "
                         f"config's layer {i}")
    return _stage_fn(module, pad_to=d_max)
