"""Fundus optic-disc-crop preprocessing: raw REFUGE-style frames -> the
disc-centred crops SegCrop consumes (crop position in the file name).

Counterpart of ``segtran_tpu/cli/prep_fundus.py`` (reference
MNet_DeepCDR/Step_1_Disc_Crop.py). The disc is located by one of three
modes:

  * mask: the centroid of the ground truth's disc region (largest
    component, holes filled);
  * model (--cpdir/--iter): a coarse segmentation by any Segtran2d
    checkpoint of this port, built through ``cli/test2d``'s factory and
    loader: the frame is resized to --detsize (bilinear on the device),
    the disc probability thresholded (0.5, or half its max when it never
    reaches 0.5), cleaned to its largest filled component, and its
    centroid scaled back to the frame;
  * center: the frame resized to --detsize and cropped at its centre.

Crops are clamped ``roi x roi`` squares saved as
``{stem}_{roi}_{x0},{y0}.png``; raw annotations (255 background / 128 disc
/ 0 cup) become 3-channel 0/255 masks (ch0 disc incl. cup, ch1 cup).
Connected components come from ``scipy.ndimage.label`` with a 3x3
structure (cv2's default 8-connectivity), resizes from
``torch.nn.functional.interpolate`` (cv2 INTER_LINEAR's pixel-centre
mapping; a uint8 result may differ from cv2's by 1), so neither cv2 nor
Pillow is needed but for file IO, which imports Pillow when it runs.

Usage:
  python -m segtran_tpu_torch.cli.prep_fundus --images raw/images \\
      --masks raw/masks --out data/fundus/mytrain --roi 576
  python -m segtran_tpu_torch.cli.prep_fundus --images raw/images \\
      --out data/fundus/mytest --cpdir model/job --iter 8000 --bb eff-b4 \\
      --layercompress 1,1,2,2 --bf16
"""
from __future__ import annotations

import argparse
import os
from typing import Tuple

import numpy as np
import torch

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def largest_region_fill(binary: np.ndarray) -> np.ndarray:
    """Keep the largest 8-connected component and fill its holes (reference
    mnet_utils.BW_img:38-50)."""
    from scipy.ndimage import binary_fill_holes, label
    comp, n = label(binary.astype(bool), structure=np.ones((3, 3), int))
    if n == 0:
        return binary.astype(bool)
    largest = 1 + int(np.argmax(np.bincount(comp.ravel())[1:]))
    return binary_fill_holes(comp == largest)


def disc_crop(img: np.ndarray, roi: int, cx: int, cy: int
              ) -> Tuple[np.ndarray, Tuple[int, int, int, int]]:
    """Clamped roi x roi crop centred at (cx, cy) (reference
    mnet_utils.disc_crop:73-97). Returns (crop, (x0, x1, y0, y1))."""
    half = roi // 2
    c = [cx - half, cx + half, cy - half, cy + half]
    if c[0] < 0:
        c[0], c[1] = 0, roi
    if c[2] < 0:
        c[2], c[3] = 0, roi
    if c[1] > img.shape[0]:
        c[1] = img.shape[0]
        c[0] = c[1] - roi
    if c[3] > img.shape[1]:
        c[3] = img.shape[1]
        c[2] = c[3] - roi
    return img[c[0]:c[1], c[2]:c[3]], (c[0], c[1], c[2], c[3])


def map_raw_fundus_label(raw: np.ndarray) -> np.ndarray:
    """Raw REFUGE annotation (255 bg / 128 disc-excl-cup / 0 cup) -> the
    3-channel crop-mask format (ch0: disc incl. cup, ch1: cup, as 0/255;
    reference Step_1_Disc_Crop.py:84-93)."""
    if raw.ndim == 3:
        raw = raw[:, :, 0]
    out = np.zeros(raw.shape + (3,), np.uint8)
    out[raw < 200, 0] = 255
    out[raw < 100, 1] = 255
    return out


def center_from_mask(raw_label: np.ndarray) -> Tuple[int, int]:
    """Disc centroid from the ground-truth annotation."""
    if raw_label.ndim == 3:
        raw_label = raw_label[:, :, 0]
    disc = largest_region_fill(raw_label < 200)
    xs, ys = np.nonzero(disc)
    if xs.size == 0:
        return raw_label.shape[0] // 2, raw_label.shape[1] // 2
    return int(xs.mean()), int(ys.mean())


def resize_uint8(img: np.ndarray, size: int, mode: str = "bilinear",
                 device=None) -> np.ndarray:
    """A uint8 [H, W(, C)] frame resized to size x size on ``device``:
    ``bilinear`` (align_corners=False, rounded back to uint8) or
    ``nearest`` (source index floor(dst * scale)), cv2's INTER_LINEAR and
    INTER_NEAREST mappings."""
    x = torch.as_tensor(np.array(img), device=device)
    chw = (x[..., None] if x.dim() == 2 else x).permute(2, 0, 1)[None]
    kw = {"align_corners": False} if mode == "bilinear" else {}
    y = torch.nn.functional.interpolate(chw.float(), size=(size, size),
                                        mode=mode, **kw)
    y = y.round().clamp(0, 255).to(torch.uint8)[0].permute(1, 2, 0)
    y = y[..., 0] if x.dim() == 2 else y
    return y.cpu().numpy()


def center_from_model(model_fn, img: np.ndarray, detsize: int,
                      device=None) -> Tuple[int, int]:
    """Disc centroid from a coarse model segmentation of the frame resized
    to detsize (replaces the MNet DiscSeg predict + BW_img + regionprops
    chain, Step_1_Disc_Crop.py:99-106)."""
    small = resize_uint8(img, detsize, device=device)
    probs = np.asarray(model_fn(small.astype(np.float32) / 255.0))
    disc_p = probs[..., 1] if probs.shape[-1] >= 2 else probs[..., 0]
    thr = 0.5 if disc_p.max() > 0.5 else disc_p.max() / 2.0   # BW_img:39-41
    disc = largest_region_fill(disc_p > thr)
    xs, ys = np.nonzero(disc)
    if xs.size == 0:
        cx = cy = detsize // 2
    else:
        cx, cy = xs.mean(), ys.mean()
    return (int(cx * img.shape[0] / detsize),
            int(cy * img.shape[1] / detsize))


def make_model_fn(model, device):
    """[h, w, 3] float frame in [0, 1] -> sigmoid probabilities [h, w, C]
    (numpy): the model at the frame's own size, normalised with mean 0.5
    / std 0.25."""
    def model_fn(image):
        x = torch.as_tensor(image, dtype=torch.float32, device=device)
        with torch.inference_mode():
            logits = model(((x - 0.5) / 0.25)[None])
        return torch.sigmoid(logits[0].float()).cpu().numpy()
    return model_fn


def build_model_fn(args, device):
    """The coarse segmentation forward from a port checkpoint, through
    test2d's factory and loader."""
    from ..configs.presets import TASK_SETTINGS
    from ..train.checkpoint import load_checkpoint
    from .test2d import build_model
    task = dict(TASK_SETTINGS["fundus"])
    if args.patch_size:
        v = tuple(int(x) for x in str(args.patch_size).split(","))
        task["patch_size"] = v * 2 if len(v) == 1 else v
    model, cfg = build_model(args, task)
    model.load_state_dict(load_checkpoint(
        os.path.join(args.cpdir, f"iter_{args.iter_num}"), cfg), strict=True)
    return make_model_fn(model.to(device).eval(), device)


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--images", required=True, help="raw fundus image dir")
    p.add_argument("--masks", default=None,
                   help="raw annotation dir (255/128/0 bmp or png); enables "
                        "mask-mode localization and mask-crop output")
    p.add_argument("--out", required=True,
                   help="output dataset dir (images/ + masks/ created)")
    p.add_argument("--roi", type=int, default=576,
                   help="crop size (reference discROI_size, "
                        "Step_1_Disc_Crop.py:21; released crops use 576)")
    p.add_argument("--mode", default="auto",
                   choices=["auto", "mask", "model", "center"],
                   help="disc localization source (auto: mask if --masks, "
                        "else model if --cpdir, else center)")
    p.add_argument("--detsize", type=int, default=640,
                   help="detection/center resize (reference DiscSeg_size)")
    # model-mode flags (cli/test2d.py's, so any checkpoint loads)
    p.add_argument("--cpdir", default=None)
    p.add_argument("--iter", dest="iter_num", type=int, default=None)
    p.add_argument("--net", default="segtran")
    p.add_argument("--bb", dest="backbone_type", default="eff-b4")
    p.add_argument("--translayers", dest="num_translayers", type=int,
                   default=3)
    p.add_argument("--layercompress", dest="translayer_compress_ratios",
                   default=None)
    p.add_argument("--attractors", dest="num_attractors", type=int,
                   default=256)
    p.add_argument("--patchsize", dest="patch_size", default=None)
    p.add_argument("--modes", dest="num_modes", type=int, default=-1)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--device", default=None,
                   help="model mode: cuda (default) or cpu")
    return p


def main(argv=None):
    """Returns the written crop file names."""
    from PIL import Image
    args = build_argparser().parse_args(argv)
    mode = args.mode
    if mode == "auto":
        mode = ("mask" if args.masks else
                "model" if args.cpdir else "center")
    if mode == "model" and not (args.cpdir and args.iter_num is not None):
        raise ValueError("model mode needs --cpdir and --iter")

    files = sorted(f for f in os.listdir(args.images)
                   if f.lower().endswith(IMG_EXTS))
    if not files:
        raise FileNotFoundError(f"no images under {args.images}")
    out_img = os.path.join(args.out, "images")
    os.makedirs(out_img, exist_ok=True)
    out_mask = None
    if args.masks:
        out_mask = os.path.join(args.out, "masks")
        os.makedirs(out_mask, exist_ok=True)

    device = None
    model_fn = None
    if mode == "model":
        from .. import resolve_device
        device = resolve_device(args.device)
        model_fn = build_model_fn(args, device)

    written = []
    for i, name in enumerate(files):
        stem = os.path.splitext(name)[0]
        img = np.asarray(Image.open(os.path.join(args.images, name))
                         .convert("RGB"))
        raw_label = None
        if args.masks:
            for ext in (".bmp", ".png", ".jpg"):
                mp = os.path.join(args.masks, stem + ext)
                if os.path.exists(mp):
                    raw_label = np.asarray(Image.open(mp))
                    break
            if raw_label is None:
                raise FileNotFoundError(f"no mask for {name} in "
                                        f"{args.masks}")

        if mode == "mask":
            cx, cy = center_from_mask(raw_label)
        elif mode == "model":
            cx, cy = center_from_model(model_fn, img, args.detsize, device)
        else:
            # the reference's manual path: resize to detsize, centre crop
            img = resize_uint8(img, args.detsize)
            if raw_label is not None:
                raw_label = resize_uint8(raw_label, args.detsize, "nearest")
            cx = cy = args.detsize // 2

        crop, coord = disc_crop(img, args.roi, cx, cy)
        fname = "{}_{}_{},{}.png".format(stem, args.roi, coord[0], coord[2])
        Image.fromarray(crop.astype(np.uint8)).save(
            os.path.join(out_img, fname))
        if raw_label is not None:
            label3 = map_raw_fundus_label(raw_label)
            mcrop, _ = disc_crop(label3, args.roi, cx, cy)
            Image.fromarray(mcrop.astype(np.uint8)).save(
                os.path.join(out_mask, fname))
        written.append(fname)
        print(f"[{i + 1}/{len(files)}] {name} -> {fname} "
              f"(center {cx},{cy})")
    print(f"wrote {len(written)} crops -> {out_img}")
    return written


if __name__ == "__main__":
    main()
