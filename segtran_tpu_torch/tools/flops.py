"""Parameter and FLOP counting, throughput, profiler traces. Counterpart of
``segtran_tpu/tools/flops.py`` (the reference's thop/fvcore profiling:
train2d.py:1048-1062 ``--profile``, test2d.py:623-631 ``--flop``).

XLA's cost analysis of a compiled program has no PyTorch counterpart.
``estimate_flops`` counts with ``torch.utils.flop_counter.FlopCounterMode``:
the products (matmuls, convolutions, attention) as they are dispatched,
two FLOPs per multiply-add, elementwise work not counted (XLA counts it).
The hand-written kernels are custom ops with a FLOP formula each
(``kernels/_build.kernel_flops``): the products that their plain versions
compute, so a kernel counts what the unfused chain of the same products
counts. The count follows the route: ``--fused`` computes the full Q and K
projections where the unfused attention folds them into the scores
(``CrossAttFeatTrans``'s reassociation), so it counts more. ``bytes`` sums
the bytes of every dispatched op's tensor operands and results (views not
counted, each kernel one op), as XLA's ``bytes accessed`` sums its HLO
operations'.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode


def count_params(model: torch.nn.Module) -> int:
    """The model's parameters (JAX counts its ``params`` collection:
    BatchNorm's running statistics, buffers here, are not counted)."""
    return sum(p.numel() for p in model.parameters())


class _BytesMode(TorchDispatchMode):
    """Sums the bytes of each dispatched op's tensor arguments and results,
    except for ops whose results only alias their inputs (views)."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        rets = func._schema.returns
        if not rets or any(r.alias_info is None or r.alias_info.is_write
                           for r in rets):
            self.total += sum(
                t.nbytes for t in pytree.tree_leaves((args, kwargs, out))
                if isinstance(t, torch.Tensor))
        return out


def estimate_flops(fn: Callable, *args) -> Dict[str, float]:
    """Run ``fn(*args)`` once and count it. Returns {'flops', 'bytes'}.
    The forward runs with autograd recording (the counter's module tracker
    needs it; nothing is differentiated), on whatever device the arguments
    are, the meta device included."""
    nbytes = _BytesMode()
    with torch.enable_grad(), FlopCounterMode(display=False) as counter, \
            nbytes:
        fn(*args)
    return {"flops": float(counter.get_total_flops()),
            "bytes": float(nbytes.total)}


def log_flops(model: torch.nn.Module, input_shape, log,
              unit: str) -> Dict[str, float]:
    """The CLIs' ``--flop``: log the parameters and one forward's FLOPs
    and bytes on a zero input of ``input_shape`` on the model's device
    (JAX test2d/test3d; reference --flop, test2d.py:623-631)."""
    x = torch.zeros(input_shape, device=next(model.parameters()).device)
    fl = estimate_flops(model, x)
    log.info("params: %.2fM  forward: %.2f %s (%.2f GB accessed)",
             count_params(model) / 1e6, fl["flops"] / 1e9, unit,
             fl["bytes"] / 1e9)
    return fl


def _sync(args) -> None:
    for t in pytree.tree_leaves(args):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


def measure_fps(fn: Callable, *args, iters: int = 20,
                warmup: int = 3) -> float:
    """Calls per second of ``fn(*args)`` without autograd (multiply by the
    batch for images per second): one call, ``warmup`` calls, then
    ``iters`` timed calls, the device synchronised before each clock
    reading (JAX's protocol, the reference's FPS loop train2d.py
    :1055-1061)."""
    with torch.inference_mode():
        fn(*args)
        _sync(args)
        for _ in range(warmup):
            fn(*args)
        _sync(args)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        _sync(args)
        return iters / (time.perf_counter() - t0)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A ``torch.profiler`` context (CPU, and CUDA where there is a GPU)
    that writes a Chrome/TensorBoard trace (``*.pt.trace.json``) into
    ``log_dir`` when it closes; yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof
