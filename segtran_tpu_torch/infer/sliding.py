"""Batched sliding-window 2D and 3D inference with overlap blending.

Counterpart of ``segtran_tpu/infer/sliding.py`` (reference
test_util2d.py:153-223, test_util3d.py:93-184): centred zero-pad up to the
window, window starts ``min(stride * i, S - win)``, all windows of all
images gathered into one model batch, linear resize window -> model input and logits -> window
(align_corners=False), sigmoid, scatter-add with a coverage count, divide.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.resize import resize_linear


def window_grid(padded: Sequence[int], window: Sequence[int],
                stride: Sequence[int]) -> np.ndarray:
    """Window start offsets [n_windows, d]: ceil((S - win) / stride) + 1
    windows per dim, the last start clamped to S - win."""
    axes = []
    for s, w, st in zip(padded, window, stride):
        n = int(math.ceil((s - w) / st)) + 1 if s > w else 1
        axes.append([min(st * i, s - w) for i in range(n)])
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.reshape(-1) for m in mesh], axis=-1)


def _pad_centered(x: torch.Tensor, window: Sequence[int]):
    """Zero-pad the spatial dims of [B, *spatial, C] up to at least
    ``window``, centred. Returns (padded, lo_pads, orig_spatial)."""
    spatial = tuple(x.shape[1:-1])
    pads = [(max(w - s, 0) // 2, max(w - s, 0) - max(w - s, 0) // 2)
            for s, w in zip(spatial, window)]
    if any(p != (0, 0) for p in pads):
        x = F.pad(x, (0, 0) + tuple(v for p in reversed(pads) for v in p))
    return x, [p[0] for p in pads], spatial


def _window(off, window):
    return (slice(None),) + tuple(slice(int(o), int(o) + w)
                                  for o, w in zip(off, window))


def _run_windows(model_fn: Callable, x: torch.Tensor, offsets: np.ndarray,
                 window: Sequence[int], model_input_size: Sequence[int],
                 num_classes: int, window_batch: Optional[int] = None):
    """Gather windows -> model -> sigmoid -> scatter-add; x [B, *S, C]
    padded. With ``window_batch`` the model sees chunks of that many
    windows, the last chunk zero-padded to full size."""
    b = x.shape[0]
    n_win = offsets.shape[0]
    # window-major gather: [n_win * B, *window, C]
    patches = torch.cat([x[_window(off, window)] for off in offsets], dim=0)
    if tuple(model_input_size) != tuple(window):
        patches = resize_linear(patches, model_input_size)
    total = n_win * b
    if window_batch is None or total <= window_batch:
        logits = model_fn(patches)
    else:
        chunks = []
        for i in range(0, total, window_batch):
            chunk = patches[i:i + window_batch]
            short = window_batch - chunk.shape[0]
            if short:
                chunk = torch.cat([chunk, chunk.new_zeros(
                    (short,) + tuple(chunk.shape[1:]))])
            chunks.append(model_fn(chunk)[:window_batch - short])
        logits = torch.cat(chunks)
    if tuple(logits.shape[1:-1]) != tuple(window):
        logits = resize_linear(logits, window)
    probs = torch.sigmoid(logits.float()).reshape(
        (n_win, b) + tuple(window) + (num_classes,))

    canvas = torch.zeros((b,) + tuple(x.shape[1:-1]) + (num_classes,),
                         dtype=torch.float32, device=x.device)
    count = torch.zeros((1,) + tuple(x.shape[1:-1]) + (1,),
                        dtype=torch.float32, device=x.device)
    for i, off in enumerate(offsets):
        canvas[_window(off, window)] += probs[i]
        count[_window(off, window)] += 1.0
    return canvas / count, count


def _crop(preds, lo, orig_spatial):
    return preds[(slice(None),) + tuple(slice(l, l + s) for l, s in
                                        zip(lo, orig_spatial))]


def sliding_window_2d(model_fn: Callable, image: torch.Tensor,
                      orig_input_size: Tuple[int, int],
                      patch_size: Tuple[int, int],
                      stride: Optional[Tuple[int, int]] = None,
                      num_classes: int = 2) -> torch.Tensor:
    """image [B, H, W, C] -> blended probs [B, H, W, num_classes];
    model_fn maps [N, *patch_size, C] to logits [N, h, w, num_classes]
    (all windows of all images in one call)."""
    stride = stride or (orig_input_size[0] // 2, orig_input_size[1] // 2)
    x, lo, orig_spatial = _pad_centered(image, orig_input_size)
    offsets = window_grid(x.shape[1:3], orig_input_size, stride)
    preds, _ = _run_windows(model_fn, x, offsets, orig_input_size, patch_size,
                            num_classes)
    return _crop(preds, lo, orig_spatial)


def sliding_window_3d(model_fn: Callable, volume: torch.Tensor,
                      orig_patch_size: Tuple[int, int, int],
                      input_patch_size: Tuple[int, int, int],
                      stride: Optional[Tuple[int, int, int]] = None,
                      num_classes: int = 4,
                      window_batch: Optional[int] = 8) -> torch.Tensor:
    """volume [B, H, W, D, C] -> blended probs [B, H, W, D, num_classes]
    (reference test_util3d.py:93-184), windows in chunks of
    ``window_batch`` model calls."""
    stride = stride or tuple(s // 2 for s in orig_patch_size)
    x, lo, orig_spatial = _pad_centered(volume, orig_patch_size)
    offsets = window_grid(x.shape[1:-1], orig_patch_size, stride)
    preds, _ = _run_windows(model_fn, x, offsets, orig_patch_size,
                            input_patch_size, num_classes, window_batch)
    return _crop(preds, lo, orig_spatial)
