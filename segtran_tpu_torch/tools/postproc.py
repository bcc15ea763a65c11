"""Prediction post-processing. Counterpart of
``segtran_tpu/tools/postproc.py``.

remove_fragmentary_segs: keep only the largest connected components
(reference test_util2d.py:267-289 keeps the top 2 by area with cv2)."""
from __future__ import annotations

import numpy as np
from scipy import ndimage


def remove_fragmentary_segs(mask: np.ndarray, keep_top: int = 2) -> np.ndarray:
    """mask: [H, W] binary or integer. Zeroes all but the ``keep_top``
    largest nonzero 8-connected components (cv2.connectedComponents'
    default connectivity, through scipy as JAX's cv2-free branch labels
    them); a mask of at most one component comes back as it is, and the
    result keeps the mask's dtype."""
    labels, n = ndimage.label(mask > 0, structure=np.ones((3, 3), np.int32))
    n += 1                                  # labels counted with background
    if n <= 2:
        return mask
    areas = [(labels == i).sum() for i in range(1, n)]
    keep = np.argsort(areas)[::-1][:keep_top] + 1
    out = np.where(np.isin(labels, keep), mask, 0)
    return out.astype(mask.dtype)
