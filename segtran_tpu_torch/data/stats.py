"""Per-dataset pixel mean/std tables and their selection (counterpart of
``segtran_tpu/data/stats.py``; the reference's seven
``{task}-...-gray{alpha:.1f}-stats.json`` tables, train2d.py:406-414).

Selection: an explicit ``--stats`` JSON wins; else the built-in table for
(task, round(alpha, 1)); an unknown alpha raises; a dataset missing from
the table falls back to mean 0.5 / std 0.25 with a warning.
"""
from __future__ import annotations

import json
import logging

logger = logging.getLogger("segtran_tpu_torch")

# reference fundus-cropped-gray0.0-stats.json
_FUNDUS_0 = {
    "mean": {"train": [0.496, 0.288, 0.143], "test": [0.690, 0.486, 0.383],
             "valid": [0.699, 0.488, 0.376], "valid2": [0.695, 0.397, 0.175],
             "gamma-train": [0.668, 0.375, 0.159],
             "gamma-valid": [0.668, 0.375, 0.159],
             "gamma-test": [0.668, 0.375, 0.159]},
    "std": {"train": [0.217, 0.143, 0.084], "test": [0.184, 0.172, 0.134],
            "valid": [0.183, 0.171, 0.134], "valid2": [0.209, 0.161, 0.132],
            "gamma-train": [0.237, 0.179, 0.139],
            "gamma-valid": [0.237, 0.179, 0.139],
            "gamma-test": [0.237, 0.179, 0.139]},
}

# reference fundus-cropped-gray0.5-stats.json
_FUNDUS_5 = {
    "mean": {"train": [0.415, 0.311, 0.238], "test": [0.612, 0.510, 0.459],
             "valid": [0.619, 0.513, 0.457], "valid2": [0.578, 0.429, 0.318],
             "test2": [0.502, 0.370, 0.285], "drishti": [0.419, 0.282, 0.192],
             "rim": [0.274, 0.157, 0.117],
             "train-cyclegan": [0.298, 0.176, 0.133],
             "rim-cyclegan": [0.414, 0.312, 0.236],
             "gamma-train": [0.553, 0.406, 0.298],
             "gamma-valid": [0.553, 0.406, 0.298],
             "seed1": [0.591, 0.432, 0.315]},
    "std": {"train": [0.180, 0.145, 0.112], "test": [0.174, 0.169, 0.149],
            "valid": [0.173, 0.168, 0.148], "valid2": [0.184, 0.162, 0.144],
            "test2": [0.197, 0.169, 0.141], "drishti": [0.145, 0.119, 0.083],
            "rim": [0.148, 0.106, 0.079],
            "train-cyclegan": [0.147, 0.107, 0.083],
            "rim-cyclegan": [0.157, 0.133, 0.101],
            "gamma-train": [0.208, 0.181, 0.156],
            "gamma-valid": [0.208, 0.181, 0.156],
            "seed1": [0.132, 0.115, 0.092]},
}

# reference fundus-cropped-gray1.0-stats.json
_FUNDUS_10 = {
    "mean": {"train": [0.334, 0.334, 0.334], "test": [0.535, 0.535, 0.535],
             "valid": [0.538, 0.538, 0.538], "valid2": [0.461, 0.461, 0.461]},
    "std": {"train": [0.149, 0.149, 0.149], "test": [0.167, 0.167, 0.167],
            "valid": [0.166, 0.166, 0.166], "valid2": [0.165, 0.165, 0.165]},
}

# reference polyp-whole-gray0.0-stats.json
_POLYP_0 = {
    "mean": {"CVC-ClinicDB-train": [0.399, 0.269, 0.184],
             "CVC-ClinicDB-test": [0.399, 0.269, 0.184],
             "Kvasir-train": [0.562, 0.327, 0.243],
             "Kvasir-test": [0.562, 0.327, 0.243],
             "CVC-300": [0.460, 0.304, 0.243],
             "CVC-ColonDB": [0.435, 0.284, 0.186],
             "ETIS-LaribPolypDB": [0.601, 0.431, 0.372]},
    "std": {"CVC-ClinicDB-train": [0.298, 0.205, 0.141],
            "CVC-ClinicDB-test": [0.298, 0.205, 0.141],
            "Kvasir-train": [0.315, 0.221, 0.189],
            "Kvasir-test": [0.315, 0.221, 0.189],
            "CVC-300": [0.309, 0.229, 0.192],
            "CVC-ColonDB": [0.311, 0.231, 0.168],
            "ETIS-LaribPolypDB": [0.265, 0.238, 0.222]},
}

# reference polyp-whole-gray0.5-stats.json
_POLYP_5 = {
    "mean": {"CVC-ClinicDB-train": [0.348, 0.283, 0.241],
             "CVC-ClinicDB-test": [0.348, 0.283, 0.241],
             "Kvasir-train": [0.475, 0.357, 0.315],
             "Kvasir-test": [0.475, 0.357, 0.315],
             "CVC-300": [0.402, 0.324, 0.293],
             "CVC-ColonDB": [0.376, 0.301, 0.252],
             "ETIS-LaribPolypDB": [0.538, 0.453, 0.424],
             "CVC-ClinicDB-train-cyclegan": [0.348, 0.283, 0.241],
             "CVC-300-cyclegan": [0.359, 0.303, 0.260]},
    "std": {"CVC-ClinicDB-train": [0.259, 0.213, 0.178],
            "CVC-ClinicDB-test": [0.259, 0.213, 0.178],
            "Kvasir-train": [0.274, 0.229, 0.210],
            "Kvasir-test": [0.274, 0.229, 0.210],
            "CVC-300": [0.277, 0.237, 0.218],
            "CVC-ColonDB": [0.276, 0.237, 0.201],
            "ETIS-LaribPolypDB": [0.252, 0.240, 0.230],
            "CVC-ClinicDB-train-cyclegan": [0.259, 0.213, 0.178],
            "CVC-300-cyclegan": [0.246, 0.216, 0.189]},
}

# reference polyp-whole-gray1.0-stats.json
_POLYP_10 = {
    "mean": {"CVC-ClinicDB-train": [0.298, 0.298, 0.298],
             "CVC-ClinicDB-test": [0.298, 0.298, 0.298],
             "Kvasir-train": [0.388, 0.388, 0.388],
             "Kvasir-test": [0.388, 0.388, 0.388],
             "CVC-300": [0.344, 0.344, 0.344],
             "CVC-ColonDB": [0.318, 0.318, 0.318],
             "ETIS-LaribPolypDB": [0.475, 0.475, 0.475]},
    "std": {"CVC-ClinicDB-train": [0.222, 0.222, 0.222],
            "CVC-ClinicDB-test": [0.222, 0.222, 0.222],
            "Kvasir-train": [0.239, 0.239, 0.239],
            "Kvasir-test": [0.239, 0.239, 0.239],
            "CVC-300": [0.246, 0.246, 0.246],
            "CVC-ColonDB": [0.243, 0.243, 0.243],
            "ETIS-LaribPolypDB": [0.242, 0.242, 0.242]},
}

# reference oct-whole-gray0.5-stats.json
_OCT_5 = {
    "mean": {"duke": [0.200, 0.200, 0.200]},
    "std": {"duke": [0.153, 0.153, 0.153]},
}

DS_STATS = {
    ("fundus", 0.0): _FUNDUS_0,
    ("fundus", 0.5): _FUNDUS_5,
    ("fundus", 1.0): _FUNDUS_10,
    ("polyp", 0.0): _POLYP_0,
    ("polyp", 0.5): _POLYP_5,
    ("polyp", 1.0): _POLYP_10,
    ("oct", 0.5): _OCT_5,
}

_DEFAULT = ((0.5, 0.5, 0.5), (0.25, 0.25, 0.25))


def load_dataset_stats(task_name, gray_alpha, ds_name, stats_json=None):
    """Return (mean, std) rgb tuples for ``ds_name`` under the task's
    --gray alpha, mirroring the reference's per-run JSON auto-selection
    (train2d.py:406-414). ``stats_json`` (an explicit --stats path in the
    same schema) overrides the built-ins."""
    if stats_json:
        with open(stats_json) as f:
            stats = json.load(f)
        logger.info("'%s' mean/std loaded from '%s'", task_name, stats_json)
        return (tuple(stats["mean"][ds_name]), tuple(stats["std"][ds_name]))
    key = (task_name, round(float(gray_alpha), 1))
    table = DS_STATS.get(key)
    if table is None:
        avail = sorted(a for t, a in DS_STATS if t == task_name)
        if not avail:
            # tasks with no reference stats tables (e.g. custom): neutral
            logger.warning("no built-in pixel stats for task '%s'; "
                           "normalizing with mean 0.5 / std 0.25 "
                           "(pass --stats for real values)", task_name)
            return _DEFAULT
        raise ValueError(
            f"no built-in '{task_name}' pixel stats for --gray "
            f"{gray_alpha}; available alphas: {avail} (the reference only "
            f"ships those JSONs) — or pass an explicit --stats file")
    if ds_name not in table["mean"]:
        logger.warning(
            "dataset '%s' not in the built-in '%s' gray%.1f stats table; "
            "normalizing with mean 0.5 / std 0.25 — pass --stats or measure "
            "with tools/analysis.compute_dataset_stats", ds_name, task_name,
            key[1])
        return _DEFAULT
    logger.info("'%s' mean/std: built-in %s gray%.1f table, dataset '%s'",
                task_name, task_name, key[1], ds_name)
    return (tuple(table["mean"][ds_name]), tuple(table["std"][ds_name]))
