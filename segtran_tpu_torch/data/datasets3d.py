"""BraTS volumes from preprocessed h5 files (counterpart of ``BratsSet``
in ``segtran_tpu/data/datasets3d.py``; reference datasets3d.py:331-454,
456-545). Each case file holds 'image' [4, H, W, D] (or channels-last) and
'label' [H, W, D] with raw labels {0, 1, 2, 4}.

``mode='train'`` with a ``crop_size`` zero-pads each volume up to the crop
and takes a random crop. The crop of a sample is drawn from (seed, epoch,
index), set with ``set_epoch``: the same on every run, whatever the
loader threads do (the JAX loader shares one RandomState across its
threads, so its crops depend on their timing).

Reading h5 needs h5py, imported at use: without it the loader raises.
The modality choice and axis permutation come with the atria/MSD
datasets.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("reading BraTS h5 volumes needs the h5py package, "
                          "which is not installed") from e
    return h5py


def pad_to_size(image: np.ndarray, label: Optional[np.ndarray],
                size: Sequence[int]):
    """Symmetric zero pad of the spatial dims up to ``size`` (reference
    :470-481)."""
    pads = []
    for s, t in zip(image.shape[:3], size):
        p = max(t - s, 0)
        pads.append((p // 2, p - p // 2))
    if any(p != (0, 0) for p in pads):
        image = np.pad(image, pads + [(0, 0)] * (image.ndim - 3))
        if label is not None:
            label = np.pad(label, pads)
    return image, label


def random_crop(image: np.ndarray, label: Optional[np.ndarray],
                size: Sequence[int], rng):
    """Pad to ``size``, then a crop at starts drawn from ``rng`` (a numpy
    Generator)."""
    image, label = pad_to_size(image, label, size)
    starts = [int(rng.integers(0, s - t + 1))
              for s, t in zip(image.shape[:3], size)]
    sl = tuple(slice(st, st + t) for st, t in zip(starts, size))
    return image[sl], (label[sl] if label is not None else None)


@dataclass
class BratsSet:
    """Samples {image [H, W, D, C] fp32, label [H, W, D] with ET remapped
    4 -> 3, index, name}."""
    base_dir: str
    split: str = "all"
    mode: str = "train"            # train: random crop (with crop_size)
    crop_size: Optional[Tuple[int, int, int]] = None
    binarize: bool = False
    remap_label4: bool = True      # raw ET label 4 -> 3 (reference :404)
    seed: int = 0
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
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self):
        return len(self.case_list)

    def _path(self, name):
        p = os.path.join(self.base_dir, name)
        return p if p.endswith(".h5") else p + ".h5"

    def read(self, idx):
        """(image, label or None) of case ``idx`` as stored."""
        with _h5py().File(self._path(self.case_list[idx]), "r") as f:
            image = np.asarray(f[self.image_key], np.float32)
            label = (np.asarray(f[self.label_key]) if self.label_key in f
                     else None)
        return image, label

    def __getitem__(self, idx):
        image, label = self.read(idx)
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
        if self.mode == "train" and self.crop_size is not None:
            rng = np.random.default_rng((self.seed, self.epoch, int(idx)))
            image, label = random_crop(image, label, self.crop_size, rng)
        return {"image": np.ascontiguousarray(image),
                "label": (np.ascontiguousarray(label) if label is not None
                          else np.zeros(image.shape[:3], np.uint8)),
                "index": idx, "name": self.case_list[idx]}
