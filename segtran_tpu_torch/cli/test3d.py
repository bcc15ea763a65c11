"""3D evaluation of Segtran3d on a CUDA GPU: whole-volume or sliding-window
inference, Dice/Jaccard (+ HD95/ASD with medpy), prediction export.

Counterpart of ``segtran_tpu/cli/test3d.py`` for ``--net segtran
--segtran 3d`` on BraTS. Per volume (``evaluate_volume``): the whole
volume, zero-padded up to multiples of (16, 16, 8), in one forward
(``--wholevol``) or overlapping windows; sigmoid; BraTS predictions made
class-consistent (WT >= TC >= ET); per-class metrics on the hardened map;
with ``--outdir`` the raw-label prediction (ET written back as 4) as
``.npz`` (and ``.nii.gz`` when nibabel is installed), tarred into
``pred.tar``. Flags whose modules belong to a later slice of the port
raise NotImplementedError.

Example (GPU; BraTS h5 files need h5py):
  python -m segtran_tpu_torch.cli.test3d --task brats --ds 2019valid \\
      --cpdir model/segtran-brats --iters 8000 --wholevol --fused \\
      --fusedepi --bf16
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import tarfile

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..configs.base import Segtran3dConfig
from ..configs.presets import TASK_SETTINGS
from ..data.labelmaps import harden_segmap
from ..data.labelmaps3d import (brats_inv_map_label, brats_map_label,
                                make_brats_pred_consistent)
from ..infer.metrics import (dice_score_nd, jaccard_score, log_metric_stack,
                             surface_metrics)
from ..infer.sliding import sliding_window_3d
from ..models.segtran3d import Segtran3d, init_segtran3d
from ..train.checkpoint import load_checkpoint

# the strides of every 3D variant: x/y by 16, depth by 8
WHOLEVOL_MULTIPLES = (16, 16, 8)


def build_argparser():
    p = argparse.ArgumentParser(
        description="segtran_tpu_torch 3D evaluation (Segtran3d, BraTS)")
    p.add_argument("--task", dest="task_name", default="brats")
    p.add_argument("--net", default="segtran")
    p.add_argument("--segtran", dest="segtran_type", default="3d")
    p.add_argument("--spatialshard", dest="spatial_shard",
                   action="store_true")
    p.add_argument("--wholevol", action="store_true",
                   help="one whole-volume forward instead of sliding "
                        "windows")
    p.add_argument("--ds", dest="ds_name", default=None,
                   help="dataset dir under dataroot/<task>/ (default "
                        "2019valid)")
    p.add_argument("--split", default="all")
    p.add_argument("--dataroot", default="../data")
    p.add_argument("--translayers", dest="num_translayers", type=int,
                   default=1)
    p.add_argument("--layercompress", dest="translayer_compress_ratios",
                   default=None)
    p.add_argument("--attractors", dest="num_attractors", type=int,
                   default=1024)
    p.add_argument("--upd", dest="out_fpn_upsampleD_scheme", default=None,
                   choices=[None, "interp", "conv", "none"])
    p.add_argument("--pos", dest="pos_code_type", default="lsinu")
    p.add_argument("--nosqueeze", dest="use_squeezed_transformer",
                   action="store_false")
    p.add_argument("--multihead", dest="ablate_multihead",
                   action="store_true")
    p.add_argument("--modes", dest="num_modes", type=int, default=4)
    p.add_argument("--noqkbias", dest="qk_have_bias", action="store_false")
    p.add_argument("--infpn", dest="in_fpn_layers", default="34")
    p.add_argument("--outfpn", dest="out_fpn_layers", default="1234")
    p.add_argument("--attnclip", dest="attn_clip", type=float, default=500.0)
    p.add_argument("--posw", dest="pos_code_weight", type=float, default=1.0)
    p.add_argument("--squeezeuseffn", dest="has_FFN_in_squeeze",
                   action="store_true")
    p.add_argument("--nofeatup", dest="bb_feat_upsize",
                   action="store_false")
    p.add_argument("--dpool", dest="d_pool_k", type=int, default=-1)
    p.add_argument("--cpdir", required=True)
    p.add_argument("--iters", default=None,
                   help="checkpoint iterations: 1,2 or 1000-8000,1000; "
                        "none: seeded random weights")
    p.add_argument("--bs", dest="window_batch", type=int, default=8,
                   help="windows per model call")
    p.add_argument("--patchsize", dest="orig_patch_size", default=None)
    p.add_argument("--inputsize", dest="input_patch_size", default=None)
    p.add_argument("--outdir", default=None)
    p.add_argument("--testinterp", dest="test_interp", default=None)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--fused", dest="use_fused_attention",
                   action="store_true",
                   help="CUDA flash cross-attention in the squeezed layer")
    p.add_argument("--fusedepi", dest="use_fused_epilogue",
                   action="store_true",
                   help="CUDA fused output+LN+mode-pool epilogue")
    p.add_argument("--verbose", dest="verbose_output", action="store_true")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; no GPU and no --device cpu "
                        "is an error")
    return p


# the encoder runs both in 3-D; Segtran3d is not yet held to JAX under them
_ITEM4_3D = ("ROADMAP Queue 1 item 4: --pos / --nosqueeze in 3-D, which "
             "need a Segtran3d parity test")


def _refuse_later_slices(args) -> None:
    later = [
        (args.task_name != "brats", f"--task {args.task_name}",
         "the atria/MSD datasets"),
        (args.net != "segtran", f"--net {args.net}", "the 3D model zoo"),
        (args.segtran_type != "3d", f"--segtran {args.segtran_type}",
         "the 2.5D/mince slice"),
        (args.spatial_shard, "--spatialshard", "the multi-GPU slice"),
        (args.test_interp is not None, "--testinterp",
         "the evaluation tools"),
        (args.pos_code_type not in ("lsinu", "none"),
         f"--pos {args.pos_code_type}", _ITEM4_3D),
        (not args.use_squeezed_transformer, "--nosqueeze", _ITEM4_3D),
        (args.ablate_multihead, "--multihead", "the ablations"),
    ]
    for bad, flag, where in later:
        if bad:
            raise NotImplementedError(
                f"{flag} is not ported yet: it belongs to a later slice of "
                f"the PyTorch port ({where})")


def task_settings(args):
    task = dict(TASK_SETTINGS[args.task_name])
    for field, override in (("orig_patch_size", args.orig_patch_size),
                            ("input_patch_size", args.input_patch_size)):
        if override:
            task[field] = tuple(int(v) for v in str(override).split(","))
    return task


def segtran3d_config(args, task, **extra) -> Segtran3dConfig:
    """The Segtran3dConfig of the model flags shared by test3d and train3d
    (reference test3d.py:190-237); ``extra`` sets the training fields."""
    compress = tuple(float(x) for x in (
        args.translayer_compress_ratios
        or ",".join(["1"] * (args.num_translayers + 1))).split(","))
    kw = {}
    if args.out_fpn_upsampleD_scheme:
        kw["out_fpn_upsampleD_scheme"] = args.out_fpn_upsampleD_scheme
    if args.d_pool_k > 0:
        kw["D_pool_K"] = args.d_pool_k
    return Segtran3dConfig(
        **kw,
        num_classes=task["num_classes"],
        num_attractors=args.num_attractors,
        num_modes=args.num_modes,
        qk_have_bias=args.qk_have_bias,
        pos_code_type=args.pos_code_type,
        in_fpn_layers=tuple(int(c) for c in args.in_fpn_layers),
        out_fpn_layers=tuple(int(c) for c in args.out_fpn_layers),
        attn_clip=args.attn_clip,
        pos_code_weight=args.pos_code_weight,
        has_FFN_in_squeeze=args.has_FFN_in_squeeze,
        bb_feat_upsize=args.bb_feat_upsize,
        orig_in_channels=task["orig_in_channels"],
        use_fused_attention=args.use_fused_attention,
        use_fused_epilogue=args.use_fused_epilogue,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        **extra,
    ).derive(translayer_compress_ratios=compress)


def build_model_and_config(args, task):
    """``--net segtran --segtran 3d`` as the JAX test3d builds it, in eval
    form."""
    _refuse_later_slices(args)
    cfg = segtran3d_config(args, task)
    return Segtran3d(cfg), cfg


def parse_iters(spec):
    if spec is None:
        return [None]
    if "-" in spec:
        rng, step = spec.split(",")
        lo, hi = rng.split("-")
        return list(range(int(lo), int(hi) + 1, int(step)))
    return [int(x) for x in spec.split(",")]


def evaluate_volume(model_fn, sample, args, task, device):
    """One volume: sample {'image' [H, W, D, C], 'label' [H, W, D]} ->
    (probs [H, W, D, classes] on ``device``, hard n-hot numpy,
    {metric: [per class 1..C-1]})."""
    num_classes = task["num_classes"]
    vol = torch.from_numpy(np.ascontiguousarray(sample["image"]))[None]
    vol = vol.to(device)
    with torch.inference_mode():
        if args.wholevol:
            sp = vol.shape[1:4]
            pads = [(-s) % m for s, m in zip(sp, WHOLEVOL_MULTIPLES)]
            volp = F.pad(vol, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
            logits = model_fn(volp)
            probs = torch.sigmoid(
                logits[:, :sp[0], :sp[1], :sp[2]].float())[0]
        else:
            probs = sliding_window_3d(
                model_fn, vol, tuple(task["orig_patch_size"]),
                tuple(task["input_patch_size"]), num_classes=num_classes,
                window_batch=args.window_batch)[0]
        probs = make_brats_pred_consistent(probs)
        hard = harden_segmap(probs).cpu().numpy()
    gt = brats_map_label(torch.from_numpy(sample["label"])).numpy()
    metrics = {"dice": [], "jaccard": [], "hd95": [], "asd": []}
    for cls in range(1, num_classes):
        metrics["dice"].append(dice_score_nd(hard[..., cls], gt[..., cls]))
        metrics["jaccard"].append(jaccard_score(hard[..., cls], gt[..., cls]))
        hd, asd = surface_metrics(hard[..., cls], gt[..., cls])
        metrics["hd95"].append(hd)
        metrics["asd"].append(asd)
    return probs, hard, metrics


def _export(probs, name, outdir):
    """Raw-label prediction (BraTS labels, 3 written back as 4) as .npz,
    and as .nii.gz when nibabel is installed; returns the .npz path."""
    inv = brats_inv_map_label(probs).cpu().numpy()
    pred_raw = inv.argmax(-1).astype(np.uint8)
    pred_raw[pred_raw == 3] = 4
    name = os.path.splitext(name)[0]
    path = os.path.join(outdir, name + ".npz")
    np.savez_compressed(path, pred=pred_raw)
    try:
        import nibabel as nib
        nib.save(nib.Nifti1Image(pred_raw, np.eye(4)),
                 os.path.join(outdir, name + ".nii.gz"))
    except ImportError:
        pass
    return path


def _logger(log_dir):
    os.makedirs(log_dir, exist_ok=True)
    logger = logging.getLogger("segtran_tpu_torch.test3d")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("[%(asctime)s] %(message)s", "%H:%M:%S")
    for h in (logging.FileHandler(os.path.join(log_dir, "eval3d_log.txt")),
              logging.StreamHandler(sys.stdout)):
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


def main(argv=None):
    """Returns {iteration: [mean Dice of classes 1..C-1]}."""
    from ..data.datasets3d import BratsSet
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    task = task_settings(args)
    model, cfg = build_model_and_config(args, task)
    logger = _logger(args.cpdir)
    log_metric_stack(logger)
    iters = parse_iters(args.iters)
    missing = [it for it in iters if it is not None and not os.path.isfile(
        os.path.join(args.cpdir, f"iter_{it}.pt"))]
    if missing:
        raise FileNotFoundError(
            f"checkpoint(s) not found under {args.cpdir}: "
            + ", ".join(f"iter_{it}.pt" for it in missing))
    dataset = BratsSet(
        os.path.join(args.dataroot, args.task_name,
                     args.ds_name or "2019valid"),
        split=args.split, binarize=task["binarize"])
    logger.info("%d eval volumes on %s", len(dataset), device)

    results = {}
    for it in iters:
        if it is None:
            init_segtran3d(model, seed=0)
        else:
            model.load_state_dict(load_checkpoint(
                os.path.join(args.cpdir, f"iter_{it}"), cfg), strict=True)
            logger.info("=== iter %s ===", it)
        model = model.to(device).eval()
        sums = {}
        saved = []
        for vi in range(len(dataset)):
            sample = dataset[vi]
            probs, _, metrics = evaluate_volume(model, sample, args, task,
                                                device)
            for key, vals in metrics.items():
                for cls, v in enumerate(vals, start=1):
                    if np.isfinite(v):
                        sums.setdefault((key, cls), []).append(v)
            if args.verbose_output:
                logger.info("%s: dice %s", sample["name"],
                            np.round(metrics["dice"], 4))
            if args.outdir:
                os.makedirs(args.outdir, exist_ok=True)
                saved.append(_export(probs, sample["name"], args.outdir))
        cls_dice = [float(np.mean(sums.get(("dice", c), [np.nan])))
                    for c in range(1, task["num_classes"])]
        for c, d in enumerate(cls_dice, start=1):
            logger.info("class %d dice: %.4f jaccard: %.4f", c, d,
                        float(np.mean(sums.get(("jaccard", c), [np.nan]))))
        logger.info("avg dice: %.4f", float(np.mean(cls_dice)))
        if saved:
            tpath = os.path.join(args.outdir, "pred.tar")
            with tarfile.open(tpath, "w") as t:
                for pth in saved:
                    t.add(pth, arcname=os.path.basename(pth))
            logger.info("tarred %d predictions -> %s", len(saved), tpath)
        results[it] = cls_dice
    return results


if __name__ == "__main__":
    main()
