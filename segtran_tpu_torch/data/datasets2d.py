"""2-D datasets on the host: frames pre-cropped around the optic disc
(``SegCrop``) and whole frames (``SegWhole``), and their concatenation
(counterpart of ``segtran_tpu/data/datasets2d.py``; reference
code/dataloaders/datasets2d.py:253-715).

Layout of a dataset directory: ``images/`` and ``masks/`` with the same
file names, and the list files ``all.list``, ``train.list``,
``test.list`` (``train-{k}shot.list`` for few-shot runs), made from
``images/`` by ``create_split_lists`` when missing. A cropped frame's
name carries its crop position, e.g. ``n0107_800_591,206.png``.

**Sample schema.** ``SegCrop`` and ``SegWhole`` give, per index:

* ``image`` float32 [H, W, 3] in [0, 1] (grayscale frames replicated to
  three channels, alpha dropped), resized bilinearly to ``out_size``;
* ``mask`` uint8 [H, W, C] raw mask (C = 1 for grayscale masks; zeros
  when ``has_mask`` is False), resized nearest to ``out_size``;
* ``index``, ``image_path``;
* ``crop_pos`` int [2] (row, column) from the file name, ``[0, 0]`` for
  ``SegWhole``; ``unscaled_size`` [2], the frame's size as read (before
  the resize); ``uncropped_size``, the full frame's size from the task
  preset (-1: sizes vary);
* ``weight`` float32, the dataset's weight; ``cls_label`` int32, the
  image-level grade from a GAMMA label CSV, else -1.

``ds_idx`` int32, the sample's dataset, is added by ``ConcatDataset``
alone, which the train CLI builds only for more than one ``--ds``: the
per-dataset normalisation reads it there, and nothing else does. A
single dataset's samples carry no ``ds_idx``.

The augmentation does not run here: it runs batched on the device
(``data/augment.py``). The random draws of the mask-guided localisation
crop (``train_loc_prob``) come from (seed, epoch, index), set with
``set_epoch``, so a sample does not depend on which loader thread reads
it (the JAX package shares one RandomState across its threads).

Reading and resizing image files needs Pillow, imported at use;
``reshape_mask`` needs OpenCV, imported at use.
"""
from __future__ import annotations

import csv
import os
import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading or resizing image files needs the Pillow "
                          "package, which is not installed") from e
    return Image


def load_mask(mask_path: str, binarize: bool) -> np.ndarray:
    """A raw mask file; ``binarize``: every value below 255 becomes 0 and a
    grayscale mask is replicated to 3 channels (reference :313-327)."""
    mask = np.array(_pil_image().open(mask_path, "r"))
    if binarize:
        mask = mask.copy()
        mask[mask < 255] = 0
        if mask.ndim == 2:
            mask = np.tile(mask, (3, 1, 1)).transpose([1, 2, 0])
    return mask


def localize(image: np.ndarray, mask: np.ndarray, min_output_size,
             rng: np.random.Generator):
    """Mask-guided crop: the box of the mask's nonzero pixels, padded to
    at least ``min_output_size`` and widened by a random 10-19 pixels on
    each side (reference :289-311)."""
    if isinstance(min_output_size, int):
        h = w = min_output_size
    else:
        h, w = min_output_size
    nz = np.nonzero(mask)
    minx, maxx = np.min(nz[0]), np.max(nz[0])
    miny, maxy = np.min(nz[1]), np.max(nz[1])
    px = max(h - (maxx - minx), 0) // 2
    py = max(w - (maxy - miny), 0) // 2
    m = rng.integers(10, 20, size=4)
    minx = max(minx - m[0] - px, 0)
    maxx = min(maxx + m[1] + px, h)
    miny = max(miny - m[2] - py, 0)
    maxy = min(maxy + m[3] + py, w)
    return image[minx:maxx, miny:maxy], mask[minx:maxx, miny:maxy]


def reshape_mask(mask: np.ndarray, dim: int, value: int = 255,
                 shape: Optional[str] = None) -> np.ndarray:
    """Mask-shape bias probe (reference :253-270): the region of channel
    ``dim`` equal to ``value`` replaced by its minimum-area rectangle."""
    if shape is None:
        return mask
    if shape != "rectangle":
        raise ValueError(shape)
    fg = np.nonzero(mask[:, :, dim] == value)
    if len(fg[0]) == 0:
        return mask
    try:
        import cv2
    except ImportError as e:
        raise ImportError("reshape_mask needs OpenCV (cv2), which is not "
                          "installed") from e
    fg_xy = np.stack(fg[::-1], axis=1).astype(np.float32)
    points = cv2.boxPoints(cv2.minAreaRect(fg_xy)).astype(int)
    mask2 = np.zeros(mask.shape)
    cv2.fillPoly(mask2, [points], value)
    out = mask.copy()
    out[:, :, dim] = mask2[:, :, 0]
    return out


def _read_list(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def create_split_lists(base_dir: str, frac_or_shot=0.85,
                       seed: Optional[int] = None) -> None:
    """Write all/train/test list files from ``images/``, grouping files by
    the image index before the first '_': an int is a few-shot count
    (``train-{k}shot.list``), a float the train fraction (reference
    :500-545; the same seeded permutation as the JAX package)."""
    img_dir = os.path.join(base_dir, "images")
    idx2files = {}
    for fn in sorted(os.listdir(img_dir)):
        idx2files.setdefault(fn.split("_")[0], []).append(
            os.path.join("images", fn))
    indices = list(idx2files)
    with open(os.path.join(base_dir, "all.list"), "w") as f:
        for k in indices:
            f.write("\n".join(sorted(idx2files[k])) + "\n")
    perm = np.random.RandomState(seed).permutation(indices)
    if isinstance(frac_or_shot, int):
        train_len, suffix = frac_or_shot, f"-{frac_or_shot}shot"
    else:
        train_len, suffix = int(np.floor(len(indices) * frac_or_shot)), ""
    for name, idxs in (("train", perm[:train_len]),
                       ("test", perm[train_len:])):
        with open(os.path.join(base_dir, f"{name}{suffix}.list"), "w") as f:
            for k in sorted(idxs):
                f.write("\n".join(sorted(idx2files[k])) + "\n")


def load_gamma_labels(gamma_label_path: str) -> dict:
    """GAMMA image-level glaucoma labels (reference :272-287): a CSV with a
    header, then rows 'name,onehot...' -> {name: argmax}."""
    image2label = {}
    with open(gamma_label_path) as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            image2label[row[0]] = int(np.argmax([int(v) for v in row[1:]]))
    return image2label


@dataclass
class SegCrop:
    """Frames pre-cropped around the disc; the crop position is parsed
    from the file name (reference :329-545)."""
    base_dir: str
    split: str = "train"                 # train | test | all
    sample_num: int = -1                 # > 0: few-shot list
    mask_num_classes: int = 2
    has_mask: bool = True
    ds_weight: float = 1.0
    binarize: bool = False
    train_loc_prob: float = 0.0
    chosen_size: Optional[int] = None
    uncropped_size: Tuple[int, int] | int = -1
    min_output_size: Optional[Tuple[int, int]] = None
    out_size: Optional[Tuple[int, int]] = None
    # GAMMA label CSV; None: glaucoma_label.csv in base_dir if present
    cls_label_csv: Optional[str] = None
    # 'rectangle': the channel-0 value-255 region replaced by its
    # minimum-area rectangle at load (reference --reshape)
    reshape_mask_type: Optional[str] = None
    seed: int = 0

    def __post_init__(self):
        base = self.base_dir
        csv_path = self.cls_label_csv
        if csv_path is None:
            cand = os.path.join(base, "glaucoma_label.csv")
            csv_path = cand if os.path.isfile(cand) else ""
        self.image2label = load_gamma_labels(csv_path) if csv_path else None
        if self.sample_num > 0:
            train_list = os.path.join(base,
                                      f"train-{self.sample_num}shot.list")
            if not os.path.isfile(train_list):
                create_split_lists(base, self.sample_num, self.seed)
        else:
            train_list = os.path.join(base, "train.list")
            if not os.path.isfile(train_list):
                create_split_lists(base, 0.85, self.seed)
        list_path = {"train": train_list,
                     "test": os.path.join(base, "test.list"),
                     "all": os.path.join(base, "all.list")}[self.split]
        items = _read_list(list_path)
        if self.chosen_size:
            items = [n for n in items if f"_{self.chosen_size}_" in n]
        self.image_list = items
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self):
        return len(self.image_list)

    def _cls_label(self, name: str) -> int:
        """The exact stem first, then its leading token (cropped files
        carry crop-position suffixes)."""
        if self.image2label is None:
            return -1
        stem = os.path.splitext(os.path.basename(name))[0]
        if stem in self.image2label:
            return self.image2label[stem]
        return self.image2label.get(stem.split("_")[0], -1)

    def __getitem__(self, idx: int) -> dict:
        image_cls = _pil_image()
        name = self.image_list[idx]
        m = re.search(r"(\d+),(\d+)", name)
        crop_pos = (np.array([int(m.group(1)), int(m.group(2))]) if m
                    else np.array([0, 0]))
        image = np.array(image_cls.open(os.path.join(self.base_dir, name),
                                        "r"))
        if image.ndim == 2:
            image = np.stack([image] * 3, axis=-1)
        if image.shape[-1] == 4:
            image = image[..., :3]
        if self.has_mask:
            mask = load_mask(os.path.join(self.base_dir,
                                          name.replace("images", "masks")),
                             self.binarize)
            if self.reshape_mask_type:
                mask = reshape_mask(mask if mask.ndim == 3 else mask[..., None],
                                    0, 255, shape=self.reshape_mask_type)
        else:
            mask = np.zeros(image.shape[:2] + (1,), np.uint8)
        unscaled_size = np.array(image.shape[:2])
        if self.split == "train" and self.train_loc_prob > 0:
            rng = np.random.default_rng((self.seed, self.epoch, int(idx)))
            if rng.random() < self.train_loc_prob:
                image, mask = localize(image, mask, self.min_output_size, rng)
        if mask.ndim == 2:
            mask = mask[..., None]
        if self.out_size is not None and \
                image.shape[:2] != tuple(self.out_size):
            size = (self.out_size[1], self.out_size[0])
            image = np.array(image_cls.fromarray(image).resize(
                size, image_cls.BILINEAR))
            mask = np.array(image_cls.fromarray(
                mask[..., 0] if mask.shape[-1] == 1 else mask).resize(
                    size, image_cls.NEAREST))
            if mask.ndim == 2:
                mask = mask[..., None]
        return {
            "image": image.astype(np.float32) / 255.0,
            "mask": mask,
            "index": idx,
            "image_path": os.path.join(self.base_dir, name),
            "crop_pos": crop_pos,
            "unscaled_size": unscaled_size,
            "uncropped_size": np.asarray(self.uncropped_size),
            "weight": np.float32(self.ds_weight),
            "cls_label": np.int32(self._cls_label(name)),
        }


@dataclass
class SegWhole(SegCrop):
    """Whole frames (polyp, OCT): no crop position (reference
    :548-715)."""

    def __getitem__(self, idx: int) -> dict:
        sample = super().__getitem__(idx)
        sample["crop_pos"] = np.array([0, 0])
        return sample


class ConcatDataset:
    """Several datasets as one; each sample gains ``ds_idx``, the index of
    its dataset, for the per-dataset normalisation of a multi-``--ds``
    run (reference train2d.py:844-849 and train_util.py:100-106)."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def set_epoch(self, epoch: int) -> None:
        for d in self.datasets:
            if hasattr(d, "set_epoch"):
                d.set_epoch(epoch)

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, idx):
        ds_i = int(np.searchsorted(self.offsets, idx, side="right") - 1)
        sample = self.datasets[ds_i][idx - int(self.offsets[ds_i])]
        return dict(sample, ds_idx=np.int32(ds_i))
