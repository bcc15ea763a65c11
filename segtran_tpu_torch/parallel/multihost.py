"""Process-group set-up from the launcher's environment (counterpart of
``segtran_tpu/parallel/multihost.py``; reference train2d.py:796-801).

``torchrun --nproc_per_node N`` starts one process per GPU and sets the
env:// variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``). ``init_multihost`` reads them: with
``WORLD_SIZE`` set, also to 1, it joins the group -- NCCL for a CUDA
device (after ``torch.cuda.set_device(LOCAL_RANK)``), gloo for the CPU --
and never falls back to the other backend or to no group. Without
``WORLD_SIZE`` it does nothing and the CLIs run as one process.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def init_multihost(device=None, init_method: Optional[str] = None,
                   verbose: bool = False) -> dict:
    """Join the process group the environment describes (a no-op without
    ``WORLD_SIZE`` or when a group already exists). ``device``: the CLIs'
    ``--device`` (None: cuda). Returns JAX's topology keys
    (``process_index``, ``process_count``, ``local_devices``,
    ``global_devices``); with ``verbose`` prints the rank line of a
    multi-process run."""
    dev = torch.device("cuda" if device is None else device)
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ.get("RANK", "0"))
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
            backend = "nccl"
        else:
            backend = "gloo"
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world, rank=rank)
    n = dist.get_world_size() if dist.is_initialized() else 1
    topo = {"process_index": dist.get_rank() if dist.is_initialized() else 0,
            "process_count": n, "local_devices": 1, "global_devices": n}
    if verbose and n > 1:
        print(f"multi-host: rank {topo['process_index']}/{n}, "
              f"{topo['local_devices']} local / {topo['global_devices']} "
              f"global devices", flush=True)
    return topo


def is_master() -> bool:
    """Rank-0 gating for checkpoints, logs and TensorBoard (reference
    print0/is_master, train2d.py:52-54, 641); True without a group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def from_master(obj):
    """Rank 0's ``obj`` on every rank (e.g. a job directory named from the
    clock); ``obj`` itself without a group."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def master_logging(log_dir: str, filename: str, name: str):
    """``utils/misc.setup_logging`` on rank 0; on the other ranks a logger
    that keeps only warnings (no file, no INFO lines)."""
    import logging
    from ..utils.misc import setup_logging
    if is_master():
        return setup_logging(log_dir, filename, name)
    log = logging.getLogger(name + ".rank")
    log.setLevel(logging.WARNING)
    return log
