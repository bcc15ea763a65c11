"""Segmentation colormap (reference common_util.py:63-75) and dual
file + console logging (reference train2d.py:726-736). Counterpart of
``segtran_tpu/utils/misc.py``."""
from __future__ import annotations

import logging
import os
import sys

import numpy as np


def get_seg_colormap(num_classes: int, return_torch: bool = False):
    """Jet-like colormap for multi-class mask rendering (OCT's 10 classes):
    [num_classes, 3] uint8, class 0 black."""
    cmap = np.zeros((num_classes, 3), dtype=np.uint8)
    for i in range(num_classes):
        t = i / max(num_classes - 1, 1)
        r = int(np.clip(1.5 - abs(4 * t - 3), 0, 1) * 255)
        g = int(np.clip(1.5 - abs(4 * t - 2), 0, 1) * 255)
        b = int(np.clip(1.5 - abs(4 * t - 1), 0, 1) * 255)
        cmap[i] = (r, g, b)
    cmap[0] = (0, 0, 0)
    return cmap


def setup_logging(log_dir: str, filename: str = "log.txt",
                  name: str = "segtran_tpu_torch") -> logging.Logger:
    """Logger ``name`` at INFO writing ``[HH:MM:SS] message`` lines to
    ``log_dir/filename`` and to stdout; earlier handlers are replaced."""
    os.makedirs(log_dir, exist_ok=True)
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("[%(asctime)s] %(message)s", "%H:%M:%S")
    fh = logging.FileHandler(os.path.join(log_dir, filename))
    fh.setFormatter(fmt)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger
