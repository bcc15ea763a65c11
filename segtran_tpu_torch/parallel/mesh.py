"""The device mesh and the data-parallel step (counterpart of
``segtran_tpu/parallel/mesh.py``).

JAX writes the step on the global batch and lets GSPMD place the
reductions. Here one process per GPU runs its rows of the batch:
``shard_batch_to_mesh`` keeps rank r's contiguous rows (JAX's
``P("data")`` layout, not a DistributedSampler's strided one), and
``shard_train_step`` runs the step within ``ops.norm.global_batch`` over
the mesh's ``data`` group, where the BatchNorm statistics, the batch-joint
loss terms, the augmentation draws and the metrics are the global batch's
and the gradients are averaged by an explicit all-reduce before the clip
(``train/trainer.py``). The model and optimizer state start equal on every
rank (``replicate_to_mesh``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ops.norm import global_batch, shard_rows


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def resolve_ndevices(ndevices: int, tensor_parallel: int = 1) -> int:
    """The CLIs' ``--ndevices``: -1 (or 0) means the world size, any other
    value must equal it; ``--tp`` must divide it."""
    world = world_size()
    n = world if ndevices <= 0 else ndevices
    if n != world:
        raise ValueError(
            f"--ndevices {n} does not equal the world size {world}: launch "
            f"one process per device (torchrun --nproc_per_node {n})")
    if tensor_parallel > 1 and n % tensor_parallel:
        raise ValueError(f"--tp {tensor_parallel} must divide device count "
                         f"{n}")
    return n


def check_microbatches(batch_size: int, grad_accum: int, n_devices: int,
                       tensor_parallel: int = 1) -> None:
    """JAX's rule: with --gradaccum each microbatch is itself split over
    the data axis, so it must divide by the data-parallel device count."""
    dp = n_devices // max(tensor_parallel, 1)
    if grad_accum > 1 and (batch_size // grad_accum) % dp:
        raise ValueError(
            f"microbatch size {batch_size // grad_accum} (--bs {batch_size} "
            f"/ --gradaccum {grad_accum}) must be divisible by the "
            f"data-parallel device count {dp}")


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` over the process group's ranks with
    ``mesh_dim_names=axes`` (default shape: all ranks on the first axis).
    Rank r sits at the row-major position r of ``shape``. Needs an
    initialised group (``multihost.init_multihost``)."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: launch with "
                           "torchrun (parallel/multihost.init_multihost)")
    n = resolve_ndevices(-1 if n_devices is None else n_devices)
    if shape is None:
        shape = [n] + [1] * (len(axes) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not hold {n} "
                         f"devices")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


def axis_group(mesh, axis: str):
    """The process group of ``axis`` (None without a mesh or that axis)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group(axis)


@torch.no_grad()
def replicate_to_mesh(tree, mesh=None):
    """Broadcast a module's parameters and buffers (or a dict / list of
    tensors) from global rank 0 to every rank, in place; returns it."""
    if hasattr(tree, "state_dict"):
        tensors = list(tree.parameters()) + list(tree.buffers())
    elif isinstance(tree, dict):
        tensors = list(tree.values())
    else:
        tensors = list(tree)
    if dist.is_initialized() and dist.get_world_size() > 1:
        for t in tensors:
            if isinstance(t, torch.Tensor) and t.numel():
                dist.broadcast(t.data if hasattr(t, "data") else t, src=0)
    return tree


def group_rank(group):
    """(this rank's index in ``group``, its size); (0, 1) for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def shard_batch_to_mesh(batch, mesh=None, axis: str = "data"):
    """This rank's contiguous rows of each leaf's leading (batch) dim."""
    if isinstance(batch, dict):
        return {k: shard_batch_to_mesh(v, mesh, axis)
                for k, v in batch.items()}
    rows = shard_rows(batch.shape[0], *group_rank(axis_group(mesh, axis)))
    return batch[rows[0]:rows[-1] + 1]


def shard_train_step(train_step, mesh=None, data_axis: str = "data",
                     microbatches: int = 1):
    """``train_step`` run within ``global_batch`` over the mesh's
    ``data_axis`` group: params replicated, each rank its rows, every batch
    reduction and the gradient average global. ``microbatches``: the
    step's --gradaccum. Keeps ``augment``."""
    return on_global_batch(train_step, axis_group(mesh, data_axis),
                           microbatches)


def on_global_batch(fn, group, microbatches: int = 1, before=None,
                    after=None):
    """``fn`` (and its ``augment``) run within ``global_batch(group)``,
    between ``before()`` and ``after()`` where given."""
    def step(*args, **kwargs):
        if before is not None:
            before()
        try:
            with global_batch(group, microbatches):
                return fn(*args, **kwargs)
        finally:
            if after is not None:
                after()

    if hasattr(fn, "augment"):
        def augment(*args, **kwargs):
            with global_batch(group, microbatches):
                return fn.augment(*args, **kwargs)
        step.augment = augment
    return step


class TrainMesh:
    """The training CLIs' parallel set-up (JAX train2d.py:1077-1106,
    train3d.py:395-410): without a process group nothing changes; with one,
    a (data,) mesh -- (data, model) with ``--tp`` -- the model and optimizer
    state broadcast from rank 0, with ``--tp`` this rank's slices of the
    sharded state (``tensor_parallel``), and ``wrap(step)`` the step on
    the mesh. ``shard`` is (data index, data size) for the batch loader;
    ``state_dict()`` the full state_dict (a collective under ``--tp``)."""

    def __init__(self, model, optimizer, ndevices: int = -1,
                 tensor_parallel: int = 1,
                 expert_dim_size: Optional[int] = None,
                 grad_accum: int = 1):
        self.model, self.optimizer, self.state = model, optimizer, None
        self.micro = max(grad_accum, 1)
        self.mesh, self.shard = None, (0, 1)
        if not dist.is_initialized():
            return
        n = resolve_ndevices(ndevices, tensor_parallel)
        tp = max(tensor_parallel, 1)
        self.mesh = (make_mesh(n, axes=("data", "model"), shape=(n // tp, tp))
                     if tp > 1 else make_mesh(n))
        replicate_to_mesh(model, self.mesh)
        if tp > 1 and optimizer is not None:   # --tunebn has no state
            from .tensor_parallel import shard_state_to_mesh
            self.state, _ = shard_state_to_mesh(
                model, optimizer, self.mesh, expert_dim_size=expert_dim_size)
            self.optimizer = self.state.optimizer
        self.shard = group_rank(self.mesh.get_group("data"))

    def wrap(self, step):
        if self.state is not None:
            from .tensor_parallel import shard_train_step_2d
            return shard_train_step_2d(step, self.mesh, self.state,
                                       microbatches=self.micro)
        return shard_train_step(step, self.mesh, microbatches=self.micro) \
            if self.mesh is not None else step

    def state_dict(self):
        return self.state.full_state_dict() if self.state is not None \
            else self.model.state_dict()

    def finish(self):
        """Leave the model whole (its full parameters gathered)."""
        if self.state is not None:
            self.state.gather_params()
