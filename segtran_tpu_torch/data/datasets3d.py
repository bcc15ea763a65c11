"""BraTS volumes from preprocessed h5 files, for evaluation (counterpart
of ``BratsSet`` in ``segtran_tpu/data/datasets3d.py``; reference
datasets3d.py:331-454). Each case file holds 'image' [4, H, W, D] (or
channels-last) and 'label' [H, W, D] with raw labels {0, 1, 2, 4}.

Reading h5 needs h5py, imported at use: without it the loader raises. The
training-side options (random crops, size weighting) come with the
training slice, the modality choice and axis permutation with the
atria/MSD datasets.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("reading BraTS h5 volumes needs the h5py package, "
                          "which is not installed") from e
    return h5py


@dataclass
class BratsSet:
    """Samples {image [H, W, D, C] fp32, label [H, W, D] with ET remapped
    4 -> 3, index, name}."""
    base_dir: str
    split: str = "all"
    binarize: bool = False
    remap_label4: bool = True      # raw ET label 4 -> 3 (reference :404)
    image_key: str = "image"
    label_key: str = "label"

    def __post_init__(self):
        lp = os.path.join(self.base_dir, f"{self.split}.list")
        if not os.path.isfile(lp) and self.split == "all":
            self.case_list = sorted(
                f for f in os.listdir(self.base_dir) if f.endswith(".h5"))
        else:
            with open(lp) as f:
                self.case_list = [ln.strip() for ln in f if ln.strip()]

    def __len__(self):
        return len(self.case_list)

    def _path(self, name):
        p = os.path.join(self.base_dir, name)
        return p if p.endswith(".h5") else p + ".h5"

    def __getitem__(self, idx):
        with _h5py().File(self._path(self.case_list[idx]), "r") as f:
            image = np.asarray(f[self.image_key], np.float32)
            label = (np.asarray(f[self.label_key]) if self.label_key in f
                     else None)
        if image.ndim == 4 and image.shape[0] <= 8 \
                and image.shape[0] < image.shape[-1]:
            image = image.transpose(1, 2, 3, 0)     # [C, H, W, D] stored
        elif image.ndim == 3:
            image = image[..., None]
        if label is not None:
            if self.binarize:
                label = (label >= 1).astype(np.uint8)
            elif self.remap_label4:
                label = (label - (label == 4)).astype(label.dtype)
        return {"image": image,
                "label": (label if label is not None
                          else np.zeros(image.shape[:3], np.uint8)),
                "index": idx, "name": self.case_list[idx]}
