"""Checkpoints as ``iter_N.pt`` (a torch state_dict) beside the
``iter_N.config.json`` sidecar of the JAX package's schema
(``{"iter_num": N, "config": {...}}``; ``"config": null`` for a model
without one, the U-Net). Loading checks the architecture-defining keys
against the given config and aborts on a mismatch (reference
train2d.py:584-609).

A DA run saves its net with the modules trained beside it, as JAX's
params tree ``{"net", "discriminator", "recon", "vcdr_estim" | "vc_estim"
+ "vd_estim"}`` does: every key under one of those names
(``net.inc.double_conv.0.weight``), and the sidecar lists them under
``"modules"``. ``net_state_dict`` takes the net's part of either
layout."""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict

import torch

ARCH_KEYS = (
    "backbone_type", "num_classes", "num_modes", "use_squeezed_transformer",
    "num_attractors", "translayer_dims", "in_fpn_layers", "out_fpn_layers",
    "in_fpn_scheme", "out_fpn_scheme", "pos_code_type", "qk_have_bias",
    "tie_qk_scheme", "mid_type", "trans_output_type", "bb_feat_upsize",
)


def _config_snapshot(cfg) -> Dict[str, Any]:
    d = dataclasses.asdict(cfg)
    return {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in d.items()
            if isinstance(v, (int, float, str, bool, tuple, list, type(None)))}


DA_MODULES = ("net", "discriminator", "recon", "vcdr_estim", "vc_estim",
              "vd_estim")


def save_checkpoint(ckpt_dir: str, step: int, state_dict, cfg=None) -> str:
    """Write ``iter_{step}.pt`` and its sidecar; returns the path without
    the extension, the form load_checkpoint takes."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"iter_{step}")
    cpu = {k: v.detach().cpu() for k, v in state_dict.items()}
    torch.save(cpu, path + ".pt")
    side = {"iter_num": step,
            "config": None if cfg is None else _config_snapshot(cfg)}
    tops = sorted({k.split(".", 1)[0] for k in cpu})
    if "net" in tops:
        side["modules"] = tops
    with open(path + ".config.json", "w") as f:
        json.dump(side, f, indent=2)
    return path


def net_state_dict(sd: Dict[str, Any]) -> Dict[str, Any]:
    """The net's part of a checkpoint: a plain net's state_dict as it is,
    the ``net.`` keys of a DA run's without the prefix. A state_dict with
    ``net.`` keys beside names no DA run saves raises, naming them."""
    tops = {k.split(".", 1)[0] for k in sd}
    if "net" not in tops:
        return sd
    other = sorted(tops - set(DA_MODULES))
    if other:
        raise ValueError(
            f"checkpoint layout not understood: a DA run's modules "
            f"{sorted(tops & set(DA_MODULES))} beside {other}")
    return {k[4:]: v for k, v in sd.items() if k.startswith("net.")}


def check_config_consistency(saved_cfg: Dict[str, Any], cfg,
                             strict: bool = True):
    snap = _config_snapshot(cfg)
    mismatches = [(k, saved_cfg[k], snap[k]) for k in ARCH_KEYS
                  if k in saved_cfg and k in snap and saved_cfg[k] != snap[k]]
    if mismatches and strict:
        raise ValueError(f"checkpoint/config mismatch: {mismatches}")
    return mismatches


def load_checkpoint(path: str, cfg=None, strict_config: bool = True):
    """``path`` is ``<dir>/iter_N``; returns the state_dict on the CPU."""
    sd = torch.load(path + ".pt", map_location="cpu", weights_only=True)
    cfg_json = path + ".config.json"
    if cfg is not None and os.path.isfile(cfg_json):
        with open(cfg_json) as f:
            saved = json.load(f)
        check_config_consistency(saved.get("config", {}), cfg, strict_config)
    return sd
