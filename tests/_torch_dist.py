"""Multi-rank launcher of the port's parallel tests: N ranks from
``torch.multiprocessing.spawn``, a gloo group initialised through a
``file://`` store in the test's temporary directory (never a fixed TCP
port: several test workers run at once), one intra-op thread per rank,
inputs and outputs through ``.npz`` files, and a deadline after which the
ranks are killed and the test fails, so that a hung collective cannot eat
the suite's time. Imports only torch, numpy and the port: a rank never
imports JAX."""
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DEADLINE_S = 90.0


def _entry(rank, worker, world, init_file, out_dir, kwargs, env, init):
    torch.set_num_threads(1)
    os.environ.update(env)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world))
    if init:
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=world)
    else:               # the worker joins through the init_method it gets
        kwargs = dict(kwargs, init_method=f"file://{init_file}")
    try:
        out = worker(rank, world, out_dir, **kwargs) or {}
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **{k: np.asarray(v) for k, v in out.items()})
        dist.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(worker, world, tmp_path, deadline=DEADLINE_S, env=None,
           init=True, **kwargs):
    """Run ``worker(rank, world, out_dir, **kwargs)`` on ``world`` ranks
    (``worker`` a top-level function of a module that imports no JAX);
    returns the dicts of arrays each rank's worker returned, in rank
    order. A rank that raises fails the call with its traceback; ranks
    still running at ``deadline`` seconds are killed and TimeoutError is
    raised. With ``init=False`` the ranks start without a group and the
    worker gets ``init_method`` (the file store) to join one itself."""
    out_dir = str(tmp_path)
    os.makedirs(out_dir, exist_ok=True)
    init_file = os.path.join(out_dir, f"store_{time.monotonic_ns()}")
    ctx = mp.spawn(_entry, args=(worker, world, init_file, out_dir, kwargs,
                                 dict(env or {}), init),
                   nprocs=world, join=False, start_method="spawn")
    t_end = time.monotonic() + deadline
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > t_end:
                raise TimeoutError(f"{world} ranks of {worker.__name__} "
                                   f"still running after {deadline:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    results = []
    for r in range(world):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as f:
            results.append({k: f[k] for k in f.files})
    return results


def save_inputs(path, **arrays):
    """The parent's inputs for the ranks (numpy arrays) as one .npz."""
    np.savez(path, **{k: np.asarray(v) for k, v in arrays.items()})
    return str(path)


def load_inputs(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}
