"""Batched sliding-window 2D inference with overlap blending.

Counterpart of ``segtran_tpu/infer/sliding.py`` (reference
test_util2d.py:153-223): centred zero-pad up to the window, window starts
``min(stride * i, S - win)``, all windows of all images gathered into one
model batch, bilinear resize window -> model input and logits -> window
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
    """Zero-pad H, W of [B, H, W, C] up to at least ``window``, centred.
    Returns (padded, lo_pads, orig_spatial)."""
    spatial = tuple(x.shape[1:3])
    pads = [(max(w - s, 0) // 2, max(w - s, 0) - max(w - s, 0) // 2)
            for s, w in zip(spatial, window)]
    if any(p != (0, 0) for p in pads):
        (ht, hb), (wl, wr) = pads
        x = F.pad(x, (0, 0, wl, wr, ht, hb))
    return x, [p[0] for p in pads], spatial


def _run_windows(model_fn: Callable, x: torch.Tensor, offsets: np.ndarray,
                 window: Sequence[int], model_input_size: Sequence[int],
                 num_classes: int):
    b = x.shape[0]
    wh, ww = window
    n_win = offsets.shape[0]
    # window-major gather: [n_win * B, wh, ww, C]
    patches = torch.cat([x[:, int(oh):int(oh) + wh, int(ow):int(ow) + ww]
                         for oh, ow in offsets], dim=0)
    if tuple(model_input_size) != tuple(window):
        patches = resize_linear(patches, model_input_size)
    logits = model_fn(patches)
    if tuple(logits.shape[1:3]) != tuple(window):
        logits = resize_linear(logits, window)
    probs = torch.sigmoid(logits.float()).reshape(n_win, b, wh, ww, num_classes)

    canvas = torch.zeros((b,) + tuple(x.shape[1:3]) + (num_classes,),
                         dtype=torch.float32, device=x.device)
    count = torch.zeros((1,) + tuple(x.shape[1:3]) + (1,), dtype=torch.float32,
                        device=x.device)
    for i, (oh, ow) in enumerate(offsets):
        oh, ow = int(oh), int(ow)
        canvas[:, oh:oh + wh, ow:ow + ww] += probs[i]
        count[:, oh:oh + wh, ow:ow + ww] += 1.0
    return canvas / count, count


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
    return preds[:, lo[0]:lo[0] + orig_spatial[0],
                 lo[1]:lo[1] + orig_spatial[1]]
