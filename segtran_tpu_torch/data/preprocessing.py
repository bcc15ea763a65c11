"""Offline preprocessing: raw scans -> normalized h5 volumes (counterpart
of ``segtran_tpu/data/preprocessing.py``; reference code/dataloaders/
brats_processing.py:53-138, atria_processing.py:12-72,
msd_processing.py:12-66).

* BraTS: the four modalities (flair, t1ce, t1, t2) of each case's nii.gz,
  cropped to their nonzero bounding box (training cases; optionally a box
  around the tumour), z-normalized per modality over the nonzero voxels of
  the crop, zeros kept 0 -> 'image' [4, H, W, D] fp32, 'label' [H, W, D]
  uint8;
* atria: lgemri.nrrd / laendo.nrrd, labels 255 -> 1, a box around the
  atrium (training), a z-normalization over the whole crop;
* MSD: imagesTr / labelsTr nii.gz, the nonzero z-normalization.

nibabel, pynrrd and h5py are imported when used; a missing one raises an
ImportError naming it. Usage:
  python -m segtran_tpu_torch.data.preprocessing brats --root <dir>
"""
from __future__ import annotations

import argparse
import importlib
import os
from glob import glob
from typing import Optional

import numpy as np

BRATS_MODALITIES = ("flair", "t1ce", "t1", "t2")


def _need(module: str, package: str):
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"this conversion needs the {package} package, "
                          f"which is not installed") from e


def _write_h5(path: str, image: np.ndarray, labels: np.ndarray) -> str:
    with _need("h5py", "h5py").File(path, "w") as f:
        f.create_dataset("image", data=image, compression="gzip")
        f.create_dataset("label", data=labels, compression="gzip")
    return path


def nonzero_bbox(arr: np.ndarray, axes_offset: int = 0):
    """[(min, max)] of the nonzero indices along the three spatial axes
    starting at ``axes_offset``."""
    nz = np.nonzero(arr)
    return [(int(nz[i + axes_offset].min()), int(nz[i + axes_offset].max()))
            for i in range(3)]


def localized_bbox(labels: np.ndarray, output_size, shape,
                   rng: np.random.RandomState):
    """The labels' box widened to ``output_size`` plus random margins of
    10-20 voxels in x/y and 5-10 in depth, clipped to ``shape``
    (brats_processing.py:85-103)."""
    (minx, maxx), (miny, maxy), (minz, maxz) = nonzero_bbox(labels)
    h, w, d = shape
    px = max(output_size[0] - (maxx - minx), 0) // 2
    py = max(output_size[1] - (maxy - miny), 0) // 2
    pz = max(output_size[2] - (maxz - minz), 0) // 2
    minx = max(minx - rng.randint(10, 20) - px, 0)
    maxx = min(maxx + rng.randint(10, 20) + px, h)
    miny = max(miny - rng.randint(10, 20) - py, 0)
    maxy = min(maxy + rng.randint(10, 20) + py, w)
    minz = max(minz - rng.randint(5, 10) - pz, 0)
    maxz = min(maxz + rng.randint(5, 10) + pz, d)
    return (minx, maxx), (miny, maxy), (minz, maxz)


def normalize_nonzero(image_mm: np.ndarray,
                      stats_crop: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-modality z-norm with the mean and std of the nonzero voxels of
    ``stats_crop`` (default: the image); zeros stay zero
    (brats_processing.py:121-131)."""
    if stats_crop is None:
        stats_crop = image_mm
    nonzero_mask = image_mm > 0
    out = np.empty_like(image_mm)
    for m in range(image_mm.shape[0]):
        nz = stats_crop[m][stats_crop[m] > 0]
        mean, std = float(nz.mean()), float(nz.std())
        out[m] = (image_mm[m] - mean) / std
    return out * nonzero_mask


def convert_brats_case(case_dir: str, out_path: Optional[str] = None,
                       is_training: bool = True,
                       do_localization: bool = False, seed: int = 0) -> str:
    nib = _need("nibabel", "nibabel")
    name = os.path.basename(case_dir.rstrip("/"))
    mods = [np.asarray(nib.load(os.path.join(
        case_dir, f"{name}_{mod}.nii.gz")).get_fdata(), np.float32)
        for mod in BRATS_MODALITIES]
    image_mm = np.stack(mods, axis=0)
    if is_training:
        seg = nib.load(os.path.join(case_dir, f"{name}_seg.nii.gz"))
        labels = np.asarray(seg.get_fdata(), np.uint8)
    else:
        labels = np.zeros(image_mm.shape[1:], np.uint8)
    rng = np.random.RandomState(seed)
    if is_training and do_localization:
        bb = localized_bbox(labels, (112, 112, 96), image_mm.shape[1:], rng)
    else:
        bb = nonzero_bbox(image_mm, axes_offset=1)
    (x0, x1), (y0, y1), (z0, z1) = bb
    crop = image_mm[:, x0:x1, y0:y1, z0:z1]
    if is_training:
        image_mm = crop
        labels = labels[x0:x1, y0:y1, z0:z1]
    image_mm = normalize_nonzero(image_mm, crop)
    return _write_h5(out_path or os.path.join(case_dir, name + ".h5"),
                     image_mm, labels)


def convert_brats_root(root: str, seed: int = 0):
    """Every case directory under ``root``; a root whose name says
    'validation' holds cases without labels."""
    is_training = "validation" not in root.lower()
    cases = sorted(d for d in os.listdir(root)
                   if os.path.isdir(os.path.join(root, d)))
    return [convert_brats_case(os.path.join(root, c),
                               is_training=is_training, seed=seed)
            for c in cases]


def convert_atria_root(root: str, output_size=(112, 112, 80), seed: int = 0):
    nrrd = _need("nrrd", "pynrrd")
    is_training = "validation" not in root.lower()
    rng = np.random.RandomState(seed)
    outs = []
    for image_path in sorted(glob(os.path.join(root, "*/lgemri.nrrd"))):
        image, _ = nrrd.read(image_path)
        labels, _ = nrrd.read(image_path.replace("lgemri.nrrd",
                                                 "laendo.nrrd"))
        image = image.astype(np.float32)
        labels = (labels == 255).astype(np.uint8)
        if is_training:
            (x0, x1), (y0, y1), (z0, z1) = localized_bbox(
                labels, output_size, labels.shape, rng)
            image = image[x0:x1, y0:y1, z0:z1]
            labels = labels[x0:x1, y0:y1, z0:z1]
        image = (image - image.mean()) / (image.std() + 1e-8)
        outs.append(_write_h5(
            os.path.join(os.path.dirname(image_path), "case.h5"),
            image[None], labels))
    return outs


def convert_msd_root(root: str, seed: int = 0):
    nib = _need("nibabel", "nibabel")
    outs = []
    lab_dir = os.path.join(root, "labelsTr")
    for p in sorted(glob(os.path.join(root, "imagesTr", "*.nii.gz"))):
        name = os.path.basename(p).replace(".nii.gz", "")
        image = np.asarray(nib.load(p).get_fdata(), np.float32)
        image = image[None] if image.ndim == 3 else image.transpose(3, 0, 1, 2)
        lp = os.path.join(lab_dir, os.path.basename(p))
        labels = (np.asarray(nib.load(lp).get_fdata(), np.uint8)
                  if os.path.isfile(lp)
                  else np.zeros(image.shape[1:], np.uint8))
        outs.append(_write_h5(os.path.join(root, name + ".h5"),
                              normalize_nonzero(image), labels))
    return outs


def main(argv=None):
    p = argparse.ArgumentParser(
        description="raw BraTS / atria / MSD scans -> normalized h5 volumes")
    p.add_argument("task", choices=["brats", "atria", "msd"])
    p.add_argument("--root", required=True)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    fn = {"brats": convert_brats_root, "atria": convert_atria_root,
          "msd": convert_msd_root}[args.task]
    outs = fn(args.root, seed=args.seed)
    print(f"converted {len(outs)} cases")
    return outs


if __name__ == "__main__":
    main()
