"""3-D volumes from preprocessed h5 files (counterpart of
``segtran_tpu/data/datasets3d.py``; reference datasets3d.py:147-545):
``BratsSet`` (per-case 'image' [4, H, W, D] or channels-last, 'label'
[H, W, D] with raw labels {0, 1, 2, 4}), ``AtriaSet`` (one modality,
binarized labels) and ``MSDSet`` (Medical Segmentation Decathlon tasks,
lists made from ``dataset.json`` where absent).

``mode='train'`` with a ``crop_size`` zero-pads each volume up to the crop
and takes a random crop. The crop of a sample is drawn from (seed, epoch,
index), set with ``set_epoch``: the same on every run, whatever the
loader threads do (the JAX loader shares one RandomState across its
threads, so its crops depend on their timing). ``chosen_modality`` keeps
one channel, ``xyz_permute`` permutes the spatial axes; each sample
carries a ``weight`` (``ds_weight``, scaled with the foreground fraction
under ``weight_by_size``).

Reading h5 needs h5py, imported at use: without it the loader raises.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("reading h5 volumes needs the h5py package, "
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


def center_crop(image: np.ndarray, label: Optional[np.ndarray],
                size: Sequence[int]):
    """Pad to ``size``, then the centred crop (reference :456-469)."""
    image, label = pad_to_size(image, label, size)
    starts = [(s - t) // 2 for s, t in zip(image.shape[:3], size)]
    sl = tuple(slice(st, st + t) for st, t in zip(starts, size))
    return image[sl], (label[sl] if label is not None else None)


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
    """Samples {image [H, W, D, C] fp32, label [H, W, D] (BraTS: ET
    remapped 4 -> 3; binarized: >= 1), index, weight, name}."""
    base_dir: str
    split: str = "all"
    mode: str = "train"            # train: random crop (with crop_size)
    crop_size: Optional[Tuple[int, int, int]] = None
    binarize: bool = False
    remap_label4: bool = True      # raw ET label 4 -> 3 (reference :404)
    ds_weight: float = 1.0
    weight_by_size: bool = False   # scale the weight with the tumour size
    seed: int = 0
    image_key: str = "image"
    label_key: str = "label"
    # one modality channel (-1: all; reference :218-226, 275-276) and a
    # permutation of the spatial axes (reference :410-413)
    chosen_modality: int = -1
    xyz_permute: Optional[Tuple[int, int, int]] = None

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

    def stored_shape(self, idx) -> Tuple[int, ...]:
        """The stored image's shape, read without the voxels."""
        with _h5py().File(self._path(self.case_list[idx]), "r") as f:
            return tuple(f[self.image_key].shape)

    @property
    def num_modalities(self) -> int:
        """Modalities of the stored volumes (0: a single-channel file),
        from case 0 as the reference probes them (:258-263)."""
        shape = self.stored_shape(0)
        return 0 if len(shape) == 3 else min(shape)

    def __getitem__(self, idx):
        image, label = self.read(idx)
        if image.ndim == 4 and image.shape[0] <= 8 \
                and image.shape[0] < image.shape[-1]:
            image = image.transpose(1, 2, 3, 0)     # [C, H, W, D] stored
        elif image.ndim == 3:
            image = image[..., None]
        if self.chosen_modality != -1 and image.shape[-1] > 1:
            image = image[..., self.chosen_modality:self.chosen_modality + 1]
        if self.xyz_permute is not None:
            perm = tuple(self.xyz_permute)
            image = image.transpose(perm + (3,))
            if label is not None:
                label = label.transpose(perm)
        if label is not None:
            if self.binarize:
                label = (label >= 1).astype(np.uint8)
            elif self.remap_label4:
                label = (label - (label == 4)).astype(label.dtype)
        if self.mode == "train" and self.crop_size is not None:
            rng = np.random.default_rng((self.seed, self.epoch, int(idx)))
            image, label = random_crop(image, label, self.crop_size, rng)
        weight = self.ds_weight
        if self.weight_by_size and label is not None:
            # saturating at a nominal 1% foreground (JAX datasets3d.py:143)
            frac = float((label > 0).mean())
            weight = weight * (0.5 + 0.5 * min(frac / 0.01, 1.0))
        return {"image": np.ascontiguousarray(image),
                "label": (np.ascontiguousarray(label) if label is not None
                          else np.zeros(image.shape[:3], np.uint8)),
                "index": idx, "weight": np.float32(weight),
                "name": self.case_list[idx]}


@dataclass
class AtriaSet(BratsSet):
    """Left-atrium volumes: one modality, binarized labels (reference
    :147-208)."""
    binarize: bool = True


@dataclass
class MSDSet(BratsSet):
    """Medical Segmentation Decathlon volumes (reference :210-329): no
    BraTS label remap. Without a list file, the train/test/all lists are
    made from the task's ``dataset.json`` (``create_file_list``)."""
    remap_label4: bool = False
    train_test_split: float = 0.85

    def __post_init__(self):
        lp = os.path.join(self.base_dir, f"{self.split}.list")
        jp = os.path.join(self.base_dir, "dataset.json")
        if not os.path.isfile(lp) and os.path.isfile(jp):
            self.create_file_list(jp)
        super().__post_init__()

    def create_file_list(self, json_path: str):
        """The decathlon training roster split 85/15 into train and test by
        a permutation from ``seed``, and all (reference :294-329; the
        official test set has no ground truth)."""
        with open(json_path) as fp:
            meta = json.load(fp)
        files = []
        for entry in meta["training"][:meta["numTraining"]]:
            name = entry["image"].replace(".nii.gz", ".h5")
            files.append(os.path.basename(name))
        order = np.random.RandomState(self.seed).permutation(len(files))
        n_train = int(np.floor(len(files) * self.train_test_split))
        splits = {"train": sorted(files[i] for i in order[:n_train]),
                  "test": sorted(files[i] for i in order[n_train:]),
                  "all": sorted(files)}
        for split, names in splits.items():
            with open(os.path.join(self.base_dir, f"{split}.list"),
                      "w") as f:
                f.write("\n".join(names) + "\n")
