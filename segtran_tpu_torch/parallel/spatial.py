"""Whole-volume inference with the volume's H axis sharded over a mesh axis
(counterpart of ``segtran_tpu/parallel/spatial.py``; test3d
``--spatialshard``).

JAX shards the volume's H axis over ``model`` at the jit boundary and lets
GSPMD partition the forward; the output keeps the input's sharding, so the
per-volume postprocessing runs on slabs. Here each rank of the ``model``
group holds an H slab of the input (``volume_slab``); the function
all-gathers the slabs, runs the whole forward and keeps its own H slab of
the logits -- JAX's output sharding. Per-class Dice then comes from
intersections and sums all-reduced over the group (``slab_overlap``).
This shards the output, not the work: every rank runs the whole forward
(a halo-exchange partitioned forward is a later speed item, ROADMAP).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .mesh import axis_group, group_rank


def slab_bounds(h: int, index: int, count: int):
    """(lo, hi): rank ``index``'s rows of an axis of ``h`` cut into ``count``
    slabs of ceil(h / count) rows (the last ones shorter or empty)."""
    per = -(-h // count)
    lo = min(index * per, h)
    return lo, min(lo + per, h)


def volume_slab(volume: torch.Tensor, mesh, spatial_axis: str = "model",
                axis: int = 1) -> torch.Tensor:
    """This rank's H slab (dim ``axis``) of a full volume."""
    index, count = group_rank(axis_group(mesh, spatial_axis))
    lo, hi = slab_bounds(volume.shape[axis], index, count)
    return volume.narrow(axis, lo, hi - lo)


def gather_slabs(x: torch.Tensor, group, axis: int = 1) -> torch.Tensor:
    """The full tensor from every rank's slab along ``axis`` (slabs of
    ``slab_bounds``' sizes, rank order)."""
    _, count = group_rank(group)
    if count == 1:
        return x
    sizes = torch.tensor([x.shape[axis]], device=x.device)
    all_sizes = [torch.zeros_like(sizes) for _ in range(count)]
    dist.all_gather(all_sizes, sizes, group=group)
    all_sizes = [int(s) for s in all_sizes]
    per = max(all_sizes)
    pad = list(x.shape)
    pad[axis] = per
    buf = x.new_zeros(pad)
    buf.narrow(axis, 0, x.shape[axis]).copy_(x)
    parts = [torch.empty_like(buf) for _ in range(count)]
    dist.all_gather(parts, buf.contiguous(), group=group)
    return torch.cat([p.narrow(axis, 0, n) for p, n in zip(parts, all_sizes)],
                     axis)


def sharded_whole_volume_apply(model, mesh, spatial_axis: str = "model",
                               batch_axis: Optional[str] = "data"):
    """``fn(volume_slab [B, h, W, D, C]) -> logits slab [B, h', W', D',
    K]``: the rank's H slab of the input volume (``volume_slab``) in, the
    rank's H slab of the logits out, as JAX's jit with the input sharding
    on both ends. With ``batch_axis`` in the mesh each rank keeps its own
    batch rows (no gather over it). The model (in eval mode) runs under
    inference mode."""
    group = axis_group(mesh, spatial_axis)
    index, count = group_rank(group)

    def fn(volume_slab: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            volume = gather_slabs(volume_slab, group)
            logits = model(volume)
            lo, hi = slab_bounds(logits.shape[1], index, count)
            return logits[:, lo:hi]

    fn.group, fn.index, fn.count = group, index, count
    return fn


def slab_overlap(pred: torch.Tensor, gt: torch.Tensor, group):
    """Per class (last axis) [intersection, |pred|, |gt|] of two n-hot
    slabs, summed over the group's slabs: the full volume's (fp64)."""
    p, g = pred.double(), gt.double()
    dims = tuple(range(p.dim() - 1))
    sums = torch.stack([(p * g).sum(dims), p.sum(dims), g.sum(dims)])
    if group is not None and dist.get_world_size(group) > 1:
        dist.all_reduce(sums, group=group)
    return sums
