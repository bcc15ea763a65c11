"""Sharded optimizer state and master weights on a (data x model) mesh
(counterpart of ``segtran_tpu/parallel/tensor_parallel.py``).

JAX shards every large leaf of the TrainState -- parameters and BertAdam's
moments alike -- on its widest mesh-divisible dimension over the ``model``
axis and lets GSPMD partition the step. Here the same shape rule
(``leaf_sharding_rule``, on the port's parameter shapes) decides which
parameters each rank of a ``model`` group keeps a slice of: its fp32
master slice and the optimizer's moments of that slice. The step
(``shard_train_step_2d``) all-gathers the sharded parameters within the
``model`` group before the forward, averages the gradients over ``data``,
clips on the full gradient, updates the local slices and releases the
gathered parameters. Its results equal the unsharded step's; it saves
optimizer state and master weights, not compute, which stays replicated
(compute-sharded Megatron layers are a later speed item, ROADMAP).

``--ep`` (``expert_dim_size``): a leaf whose leading dim is the mode count
([M, F, F] private kernels, [M, F] biases) is sharded on it first, so each
rank keeps whole experts. Checkpoints hold the full state_dict
(``ShardedState.full_state_dict``; ``convert/sharded.py`` carries a full
state_dict to one rank's slices and back).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from ..convert.sharded import shard_slice
from .mesh import axis_group, group_rank, on_global_batch


def leaf_sharding_rule(mesh=None, axis: str = "model",
                       min_size: int = 1 << 16,
                       expert_dim_size: Optional[int] = None,
                       axis_size: Optional[int] = None):
    """JAX's shape rule: a leaf with >= ``min_size`` elements and >= 2 dims
    is sharded (``Shard(d)``) on its widest dim divisible by the ``axis``
    size, the earlier dim on a tie; with ``expert_dim_size`` a leaf of >= 2
    dims whose leading dim equals it (and divides) on that dim whatever
    its size; everything else ``Replicate()``. ``axis_size`` stands in for
    the mesh (a test of the rule alone)."""
    m = axis_size if axis_size is not None else (
        mesh.size(mesh.mesh_dim_names.index(axis))
        if mesh is not None and axis in mesh.mesh_dim_names else 1)

    def rule(x):
        shape = tuple(getattr(x, "shape", x))
        size = 1
        for s in shape:
            size *= s
        if (m > 1 and expert_dim_size and len(shape) >= 2
                and shape[0] == expert_dim_size and shape[0] % m == 0):
            return Shard(0)
        if m > 1 and len(shape) >= 2 and size >= min_size:
            for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
                if shape[d] % m == 0 and shape[d] >= m:
                    return Shard(d)
        return Replicate()

    return rule


def state_sharding_spec(model, mesh=None, axis: str = "model",
                        min_size: int = 1 << 16,
                        expert_dim_size: Optional[int] = None,
                        axis_size: Optional[int] = None) -> Dict[str, object]:
    """{name: Shard(d) | Replicate()} over the model's state_dict (the
    optimizer's moments follow their parameters)."""
    rule = leaf_sharding_rule(mesh, axis, min_size, expert_dim_size,
                              axis_size)
    return {k: rule(v) for k, v in model.state_dict().items()}


class _ShardedOptimizer:
    """The optimizer over the local slices: BertAdam's per-tensor clip
    (``max_grad_norm``) taken on each full gradient first, then the slices
    of the gradients handed to the wrapped optimizer, which updates the
    master slices and keeps moments of their shapes."""

    def __init__(self, state: "ShardedState", optimizer):
        self.state, self.optimizer = state, optimizer

    @torch.no_grad()
    def step(self):
        st = self.state
        norms = []
        for group in self.optimizer.param_groups:
            max_norm = group.get("max_grad_norm", 0.0)
            norms.append(max_norm)
            for p in group["params"]:
                full = st.full_of.get(p, p)
                g = full.grad
                if g is not None and max_norm > 0:
                    norm = torch.linalg.vector_norm(g)
                    g = g * torch.clamp(max_norm / (norm + 1e-6), max=1.0)
                if full is p:
                    if g is not None:
                        p.grad = g
                    continue
                p.grad = None if g is None else shard_slice(
                    g, st.dims[p], st.index, st.count).contiguous()
            if max_norm > 0:
                group["max_grad_norm"] = 0.0
        try:
            self.optimizer.step()
        finally:
            for group, max_norm in zip(self.optimizer.param_groups, norms):
                if max_norm > 0:
                    group["max_grad_norm"] = max_norm


class ShardedState:
    """One rank's share of the (data x model) training state: for each
    parameter the rule shards, an fp32 master slice (the optimizer's
    parameter, so its moments are slices too); the model's parameter is
    the full tensor only between ``gather_params`` and
    ``release_params``."""

    def __init__(self, model, optimizer, mesh, axis: str = "model",
                 min_size: int = 1 << 16,
                 expert_dim_size: Optional[int] = None):
        self.model, self.mesh = model, mesh
        self.group = axis_group(mesh, axis)
        self.index, self.count = group_rank(self.group)
        self.spec = state_sharding_spec(model, mesh, axis, min_size,
                                        expert_dim_size,
                                        axis_size=self.count)
        self.full_of: Dict[torch.Tensor, torch.nn.Parameter] = {}
        self.dims: Dict[torch.Tensor, int] = {}
        local_of = {}
        for name, p in model.named_parameters():
            spec = self.spec[name]
            if not isinstance(spec, Shard):
                continue
            local = shard_slice(p.detach(), spec.dim, self.index,
                                self.count).float().clone()
            local.requires_grad_(p.requires_grad)
            local_of[p] = local
            self.full_of[local] = p
            self.dims[local] = spec.dim
        for group in optimizer.param_groups:
            group["params"] = [local_of.get(p, p) for p in group["params"]]
        for p, local in local_of.items():
            if p in optimizer.state:
                optimizer.state[local] = {
                    k: (shard_slice(v, self.dims[local], self.index,
                                    self.count).clone()
                        if torch.is_tensor(v) and v.shape == p.shape else v)
                    for k, v in optimizer.state.pop(p).items()}
        self.optimizer = _ShardedOptimizer(self, optimizer)
        self.gathered = True
        self.release_params()

    @torch.no_grad()
    def gather_params(self):
        """All-gather each sharded parameter's master slices within the
        model group into the model's full parameter (in its dtype)."""
        if self.gathered:
            return
        for local, p in self.full_of.items():
            d = self.dims[local]
            parts = [torch.empty_like(local) for _ in range(self.count)]
            if self.count > 1:
                dist.all_gather(parts, local.contiguous(), group=self.group)
            else:
                parts = [local]
            p.data = torch.cat(parts, d).to(p.dtype)
        self.gathered = True

    @torch.no_grad()
    def release_params(self):
        """Free the full copies: between steps a rank holds its slices."""
        for p in self.full_of.values():
            p.data = p.data.new_empty(0)
            p.grad = None
        self.gathered = False

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's full state_dict on the CPU (a collective within the
        model group: every rank calls it)."""
        was = self.gathered
        self.gather_params()
        sd = {k: v.detach().cpu().clone()
              for k, v in self.model.state_dict().items()}
        if not was:
            self.release_params()
        return sd


def shard_state_to_mesh(model, optimizer, mesh, axis: str = "model",
                        min_size: int = 1 << 16,
                        expert_dim_size: Optional[int] = None):
    """Keep this rank's slices of the rule's parameters and of their
    optimizer state; returns (ShardedState, spec). Use
    ``state.optimizer`` in the step."""
    state = ShardedState(model, optimizer, mesh, axis, min_size,
                         expert_dim_size)
    return state, state.spec


def shard_train_step_2d(train_step, mesh, state: ShardedState,
                        data_axis: str = "data", microbatches: int = 1):
    """The step on a (data x model) mesh: gather the sharded parameters,
    run ``train_step`` (built on ``state.optimizer``) within
    ``global_batch`` over ``data_axis`` -- gradients averaged over data,
    the clip on the full gradient, the local slices updated -- then
    release the full parameters. Keeps ``augment``."""
    return on_global_batch(train_step, axis_group(mesh, data_axis),
                           microbatches, before=state.gather_params,
                           after=state.release_params)
