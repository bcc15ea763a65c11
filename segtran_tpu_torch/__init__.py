"""PyTorch/CUDA port of segtran_tpu for NVIDIA Hopper (H100).

The JAX package ``segtran_tpu`` is the reference this package is held
against; nothing here imports it or JAX. Public functions keep the JAX
layouts (NHWC images and logits, [B, N, C] tokens, [B, M, N, A] probs).
Entry points run on ``cuda`` unless the caller asks for ``cpu``.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. Without one, raise instead of quietly running
    on the CPU: the CPU is used only when the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "segtran_tpu_torch runs on a CUDA GPU and none is available; "
            "pass device='cpu' (or --device cpu) to run the plain CPU path")
    return dev
