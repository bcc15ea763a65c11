"""Per-task and per-net defaults (reference train2d.py:245-385 and
train3d.py:218-255; the fundus, polyp, oct, brats, atria and msd entries,
every --net of train2d) and the CLI-override rule ``get_default``
(reference common_util.py:6-13)."""
from __future__ import annotations

from typing import Any, Dict

NET_SETTINGS: Dict[str, Dict[str, Any]] = {
    "unet-like": {"opt": "adamw", "lr": 1e-3, "decay": 1e-4, "grad_clip": -1},
    "segtran": {"opt": "adamw", "lr": 2e-4, "decay": 1e-4, "grad_clip": 0.1,
                # keyed by in_fpn_layers string
                "dropout_prob": {"234": 0.3, "34": 0.2, "4": 0.2},
                "num_modes": {"234": 2, "34": 4, "4": 4}},
}
for _n in ("unet", "unet-scratch", "nestedunet", "unet3plus", "deeplabv3plus",
           "deeplab-smp", "pranet", "attunet", "r2attunet", "dunet", "nnunet"):
    NET_SETTINGS[_n] = NET_SETTINGS["unet-like"]
# the ViT baselines train with segtran's settings; --net deeplabv3 has no
# entry (train2d falls back to unet-like), as in the reference
for _n in ("setr", "transunet"):
    NET_SETTINGS[_n] = NET_SETTINGS["segtran"]

TASK_SETTINGS: Dict[str, Dict[str, Any]] = {
    "fundus": {
        "num_classes": 3,
        "bce_weight": (0.0, 1.0, 2.0),
        "ds_class": "SegCrop",
        "ds_names": ("train",),
        # frame size before the disc crop; -1: sizes vary
        # (reference train2d.py:299-311)
        "uncropped_size": {"train": (2056, 2124), "test": (1634, 1634),
                           "valid": (1634, 1634), "valid2": (1940, 1940),
                           "test2": -1, "drishti": (2050, 1750),
                           "rim": (2144, 1424),
                           "train-cyclegan": (2056, 2124),
                           "rim-cyclegan": (2144, 1424),
                           "gamma-train": -1, "gamma-valid": -1,
                           "gamma-test": -1},
        "has_mask": {"train": True, "test": True, "valid": True,
                     "valid2": False, "test2": False, "drishti": True,
                     "rim": True, "train-cyclegan": True,
                     "rim-cyclegan": True, "gamma-train": True,
                     "gamma-valid": False, "gamma-test": False},
        "ds_weight": {},             # all 1.0 in the reference
        "orig_input_size": (576, 576),
        "patch_size": (288, 288),
        "binarize": False,
    },
    "polyp": {
        "num_classes": 2,
        "bce_weight": (0.0, 1.0),
        "ds_class": "SegWhole",
        "ds_names": ("CVC-ClinicDB-train", "Kvasir-train"),
        "orig_input_size": (320, 320),
        "patch_size": (320, 320),
        "binarize": True,
    },
    "oct": {
        "num_classes": 10,
        "bce_weight": (0.0,) + (1.0,) * 9,
        "ds_class": "SegWhole",
        "ds_names": ("duke",),
        "orig_input_size": (288, 512),
        "patch_size": (288, 512),
        "binarize": False,
    },
    # 3D (reference train3d.py:218-255)
    "brats": {
        "num_classes": 4,
        # bg, ET, WT, TC (reference train3d.py:222-223)
        "bce_weight": (0.0, 3.0, 1.0, 1.75),
        "orig_in_channels": 4,
        "orig_patch_size": (112, 112, 96),
        "input_patch_size": (112, 112, 96),
        "binarize": False,
    },
    "atria": {
        "num_classes": 2,
        "bce_weight": (0.0, 1.0),
        "orig_in_channels": 1,
        "orig_patch_size": (112, 112, 80),
        "input_patch_size": (112, 112, 80),
        "binarize": True,
    },
    # Medical Segmentation Decathlon (reference datasets3d.py:210-329);
    # the class count and the modality vary by task: --nclasses, --mod
    "msd": {
        "num_classes": 3,
        "bce_weight": (0.0, 1.0, 1.0),
        "orig_in_channels": -1,      # probed from the data
        "orig_patch_size": (112, 112, 80),
        "input_patch_size": (112, 112, 80),
        "binarize": False,
        "chosen_modality": -1,
        "xyz_permute": None,
    },
}


def get_default(args: Dict[str, Any], key: str, preset: Dict[str, Any],
                unset_value=None):
    """Keep the user's value of ``key`` unless it equals ``unset_value``;
    otherwise take the preset's (reference common_util.py:6-13)."""
    if args.get(key, unset_value) == unset_value and key in preset:
        args[key] = preset[key]
    return args.get(key)
