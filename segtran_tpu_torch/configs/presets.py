"""Per-task and per-net defaults (reference train2d.py:245-385 and
train3d.py:218-255; the fundus, polyp and brats entries and ``--net
segtran``)."""
from __future__ import annotations

from typing import Any, Dict

NET_SETTINGS: Dict[str, Dict[str, Any]] = {
    "segtran": {"opt": "adamw", "lr": 2e-4, "decay": 1e-4, "grad_clip": 0.1,
                # keyed by in_fpn_layers string
                "dropout_prob": {"234": 0.3, "34": 0.2, "4": 0.2},
                "num_modes": {"234": 2, "34": 4, "4": 4}},
}

TASK_SETTINGS: Dict[str, Dict[str, Any]] = {
    "fundus": {
        "num_classes": 3,
        "bce_weight": (0.0, 1.0, 2.0),
        "ds_class": "SegCrop",
        "ds_names": ("train",),
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
}
