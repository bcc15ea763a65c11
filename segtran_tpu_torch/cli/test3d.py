"""3D evaluation of Segtran3d and Segtran25d on a CUDA GPU: whole-volume
or sliding-window inference, Dice/Jaccard (+ HD95/ASD with medpy),
prediction export.

Counterpart of ``segtran_tpu/cli/test3d.py`` on the BraTS, atria and
MSD tasks: ``--net segtran`` (Segtran3d, ``--segtran 25d`` Segtran25d),
``--net vnet`` (VNet with group norm) and ``--net unet``
(Modified3DUNet); ``--fused`` and ``--fusedepi`` reach only Segtran.
Per volume (``evaluate_volume``): the whole volume, zero-padded up to
multiples of (16, 16, 8), in one forward (``--wholevol``) or
overlapping windows; sigmoid; BraTS predictions made
class-consistent (WT >= TC >= ET); per-class metrics on the hardened map;
with ``--outdir`` the raw-label prediction (BraTS: ET written back as 4)
as ``.npz`` (and ``.nii.gz`` when nibabel is installed), tarred into
``pred.tar``. ``--testinterp`` scores the ground truth down- and
upsampled instead of a model. The 3-D zoo nets halve every axis four
times: a (padded) volume whose sizes are not multiples of 16 raises a
ValueError naming its shape. The flags of a later slice of the port
(multi-GPU, ``--flop``) raise NotImplementedError naming their ROADMAP
item.

Example (GPU; h5 files need h5py):
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
from ..configs.base import Segtran3dConfig, Segtran25dConfig
from ..configs.presets import TASK_SETTINGS
from ..data.labelmaps import harden_segmap, index_to_onehot
from ..data.labelmaps3d import (brats_inv_map_label, brats_map_label,
                                make_brats_pred_consistent)
from ..infer.metrics import (dice_score_nd, jaccard_score, log_metric_stack,
                             surface_metrics)
from ..infer.sliding import sliding_window_3d
from ..models.segtran3d import Segtran3d, init_segtran3d
from ..models.segtran25d import Segtran25d
from ..models.unet3d import Modified3DUNet
from ..models.vnet import VNet
from ..ops.resize import resize_linear
from ..train.checkpoint import load_checkpoint

# the strides of every 3D variant: x/y by 16, depth by 8
WHOLEVOL_MULTIPLES = (16, 16, 8)

_MULTI_GPU = "ROADMAP Queue 1 item 6b: parallel/"
_TOOLS = "ROADMAP Queue 1 item 6c: the tools"


def add_model_args(p) -> None:
    """The model and dataset flags test3d and train3d share (JAX
    cli/test3d.py and cli/train3d.py argparsers)."""
    p.add_argument("--task", dest="task_name", default="brats",
                   choices=["brats", "atria", "msd"])
    p.add_argument("--ds", dest="ds_name", default=None,
                   help="dataset dir under dataroot/<task>/")
    p.add_argument("--nclasses", dest="num_classes", type=int, default=-1,
                   help="override the task's class count (MSD tasks vary)")
    p.add_argument("--mod", dest="chosen_modality", type=int, default=-1,
                   help="the modality channel to use (-1: all)")
    p.add_argument("--xyzpermute", dest="xyz_permute", default=None,
                   help="spatial axis permutation, e.g. 1,2,0")
    p.add_argument("--dataroot", default="../data")
    p.add_argument("--net", default="segtran",
                   choices=["segtran", "vnet", "unet"])
    p.add_argument("--segtran", dest="segtran_type", default="3d",
                   choices=["3d", "25d"])
    p.add_argument("--bb", dest="backbone_type", default=None,
                   help="i3d (3d) or eff-b* (25d)")
    p.add_argument("--into3", dest="inchan_to3_scheme", default=None,
                   choices=[None, "avgto3", "only1", "dup3", "bridgeconv",
                            "stemconv"])
    p.add_argument("--pos", dest="pos_code_type", default="lsinu",
                   choices=["lsinu", "rand", "sinu", "none", "bias"])
    p.add_argument("--nosqueeze", dest="use_squeezed_transformer",
                   action="store_false")
    p.add_argument("--multihead", dest="ablate_multihead",
                   action="store_true")
    p.add_argument("--infpn", dest="in_fpn_layers", default="34")
    p.add_argument("--outfpn", dest="out_fpn_layers", default="1234")
    p.add_argument("--attnclip", dest="attn_clip", type=float, default=500.0)
    p.add_argument("--posw", dest="pos_code_weight", type=float, default=1.0)
    p.add_argument("--posr", dest="pos_bias_radius", type=int, default=7)
    p.add_argument("--squeezeuseffn", dest="has_FFN_in_squeeze",
                   action="store_true")
    p.add_argument("--inbn", dest="in_fpn_use_bn", action="store_true",
                   help="accepted; the 3-D models do not read it (as JAX)")
    p.add_argument("--nofeatup", dest="bb_feat_upsize", action="store_false")
    p.add_argument("--gbias", dest="use_global_bias", action="store_true",
                   help="accepted; the 3-D models do not read it (as JAX)")
    p.add_argument("--translayers", dest="num_translayers", type=int,
                   default=1)
    p.add_argument("--layercompress", dest="translayer_compress_ratios",
                   default=None)
    p.add_argument("--attractors", dest="num_attractors", type=int,
                   default=1024)
    p.add_argument("--modes", dest="num_modes", type=int, default=4)
    p.add_argument("--noqkbias", dest="qk_have_bias", action="store_false")
    p.add_argument("--upd", dest="out_fpn_upsampleD_scheme", default=None,
                   choices=[None, "interp", "conv", "none"],
                   help="out-FPN depth unpool (default interp for 3d, conv "
                        "for 25d)")
    p.add_argument("--dgroup", dest="d_groupsize", type=int, default=-1,
                   help="25d: merge G consecutive depth slices into the "
                        "channels (-1: 1)")
    p.add_argument("--dpool", dest="d_pool_k", type=int, default=-1,
                   help="depth pooling before the transformer (-1: 2)")
    p.add_argument("--patchsize", dest="orig_patch_size", default=None,
                   help="crop size, e.g. 112,112,96")
    p.add_argument("--inputsize", dest="input_patch_size", default=None)
    p.add_argument("--scale", dest="input_scale", default=None,
                   help="per-axis input/crop scale, e.g. 0.5,0.5,1")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; no GPU and no --device cpu "
                        "is an error")


def build_argparser():
    p = argparse.ArgumentParser(
        description="segtran_tpu_torch 3D evaluation (Segtran3d/25d)")
    add_model_args(p)
    p.add_argument("--spatialshard", dest="spatial_shard",
                   action="store_true")
    p.add_argument("--wholevol", action="store_true",
                   help="one whole-volume forward instead of sliding "
                        "windows")
    p.add_argument("--split", default="all")
    p.add_argument("--cpdir", required=True)
    p.add_argument("--iters", default=None,
                   help="checkpoint iterations: 1,2 or 1000-8000,1000; "
                        "none: seeded random weights")
    p.add_argument("--bs", dest="window_batch", type=int, default=8,
                   help="windows per model call")
    p.add_argument("--outdir", default=None)
    p.add_argument("--testinterp", dest="test_interp", default=None,
                   help="score the ground truth downsampled by these "
                        "factor(s) and restored trilinearly, e.g. 0.5 or "
                        "0.5,0.5,0.25")
    p.add_argument("--fused", dest="use_fused_attention",
                   action="store_true",
                   help="CUDA flash cross-attention in the fusion layers")
    p.add_argument("--fusedepi", dest="use_fused_epilogue",
                   action="store_true",
                   help="CUDA fused output+LN+mode-pool epilogue")
    p.add_argument("--verbose", dest="verbose_output", action="store_true")
    p.add_argument("--flop", dest="calc_flop", action="store_true")
    return p


def refuse_later_slices(args, extra=()) -> None:
    """NotImplementedError naming the ROADMAP item of a flag whose modules
    are not ported yet; ValueError for a backbone the model does not
    take."""
    for bad, flag, where in extra:
        if bad:
            raise NotImplementedError(
                f"{flag} is not ported yet: it belongs to a later slice of "
                f"the PyTorch port ({where})")
    bb = args.backbone_type
    if args.net != "segtran" or bb is None:
        return
    if not (bb.startswith(("eff-", "resnet")) if args.segtran_type == "25d"
            else bb == "i3d"):
        raise ValueError(f"--bb {bb}: the 3-D Segtran takes i3d, the 2.5D "
                         f"one an eff-* or resnet backbone")


def _refuse_later_slices(args) -> None:
    refuse_later_slices(args, [
        (args.spatial_shard, "--spatialshard", _MULTI_GPU),
        (args.calc_flop, "--flop", _TOOLS)])


def task_settings(args):
    """TASK_SETTINGS of --task with the crop / input sizes, --scale and
    --nclasses applied (JAX cli/test3d.py and cli/train3d.py)."""
    task = dict(TASK_SETTINGS[args.task_name])
    for field, override in (("orig_patch_size", args.orig_patch_size),
                            ("input_patch_size", args.input_patch_size)):
        if override:
            task[field] = tuple(int(v) for v in str(override).split(","))
    if args.input_scale and not args.input_patch_size:
        sc = [float(v) for v in str(args.input_scale).split(",")]
        task["input_patch_size"] = tuple(
            int(s * n) for s, n in zip(sc, task["orig_patch_size"]))
    if args.num_classes > 0:
        task["num_classes"] = args.num_classes
        task["bce_weight"] = (0.0,) + (1.0,) * (args.num_classes - 1)
        task["binarize"] = args.num_classes == 2
    return task


def make_dataset(args, task, mode: str, default_ds: str, crop_size=None,
                 seed: int = 0):
    """The task's dataset (BratsSet, AtriaSet or MSDSet) under
    <dataroot>/<task>/<--ds> (JAX cli/train3d.py:203-222), with
    ``probe_in_channels``."""
    from ..data.datasets3d import AtriaSet, BratsSet, MSDSet
    xyz = (tuple(int(v) for v in args.xyz_permute.split(","))
           if args.xyz_permute else task.get("xyz_permute"))
    cls = {"brats": BratsSet, "atria": AtriaSet,
           "msd": MSDSet}[args.task_name]
    ds = cls(os.path.join(args.dataroot, args.task_name,
                          args.ds_name or default_ds),
             split=args.split, mode=mode, crop_size=crop_size,
             binarize=task.get("binarize", False), seed=seed,
             chosen_modality=args.chosen_modality, xyz_permute=xyz)
    probe_in_channels(args, task, ds)
    return ds


def probe_in_channels(args, task, dataset) -> None:
    """Where the task leaves ``orig_in_channels`` to the data (-1): 1 with
    --mod, else the dataset's modality count (reference
    test3d.py:257-260)."""
    if task["orig_in_channels"] == -1:
        task["orig_in_channels"] = (1 if args.chosen_modality != -1
                                    else max(dataset.num_modalities, 1))
        task["orig_in_channels_probed"] = True


def segtran_config(args, task, **extra):
    """The Segtran3dConfig / Segtran25dConfig of the model flags shared by
    test3d and train3d (JAX cli/test3d.py:190-237); ``extra`` sets the
    training fields. --inbn and --gbias reach no 3-D model in JAX, so
    they are parsed and set nothing."""
    compress = tuple(float(x) for x in (
        args.translayer_compress_ratios
        or ",".join(["1"] * (args.num_translayers + 1))).split(","))
    kw = {}
    if args.out_fpn_upsampleD_scheme:
        kw["out_fpn_upsampleD_scheme"] = args.out_fpn_upsampleD_scheme
    if args.d_pool_k > 0:
        kw["D_pool_K"] = args.d_pool_k
    if args.d_groupsize > 0:
        kw["D_groupsize"] = args.d_groupsize
    if args.backbone_type:
        kw["backbone_type"] = args.backbone_type
    if args.inchan_to3_scheme:
        kw["inchan_to3_scheme"] = args.inchan_to3_scheme
    cls = Segtran3dConfig if args.segtran_type == "3d" else Segtran25dConfig
    return cls(
        **kw,
        num_classes=task["num_classes"],
        num_attractors=args.num_attractors,
        num_modes=args.num_modes,
        qk_have_bias=args.qk_have_bias,
        pos_code_type=args.pos_code_type,
        use_squeezed_transformer=args.use_squeezed_transformer,
        ablate_multihead=args.ablate_multihead,
        in_fpn_layers=tuple(int(c) for c in args.in_fpn_layers),
        out_fpn_layers=tuple(int(c) for c in args.out_fpn_layers),
        attn_clip=args.attn_clip,
        pos_code_weight=args.pos_code_weight,
        pos_bias_radius=args.pos_bias_radius,
        has_FFN_in_squeeze=args.has_FFN_in_squeeze,
        bb_feat_upsize=args.bb_feat_upsize,
        orig_in_channels=task["orig_in_channels"],
        use_fused_attention=args.use_fused_attention,
        use_fused_epilogue=args.use_fused_epilogue,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        **extra,
    ).derive(translayer_compress_ratios=compress)


def build_model(cfg, task):
    """Segtran3d or Segtran25d by the config's class, for inputs of the
    task's input size."""
    cls = Segtran25d if isinstance(cfg, Segtran25dConfig) else Segtran3d
    return cls(cfg, patch_size=tuple(task["input_patch_size"]))


def build_zoo_model(args, task, seed: int = 0):
    """``--net vnet`` (VNet over the task's modalities, group norm) or
    ``--net unet`` (Modified3DUNet), as JAX builds them
    (cli/train3d.py:235-245, cli/test3d.py:243-250), with PyTorch's
    default conv inits drawn from ``seed``."""
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    c, n = task["orig_in_channels"], task["num_classes"]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        if args.net == "vnet":
            return VNet(n_channels=c, num_classes=n,
                        normalization="groupnorm", dtype=dtype)
        return Modified3DUNet(in_channels=c, num_classes=n, dtype=dtype)


def build_model_and_config(args, task):
    """The --net as the JAX test3d builds it, in eval form: Segtran and
    its config, or a 3-D zoo net and None."""
    _refuse_later_slices(args)
    if args.net != "segtran":
        return build_zoo_model(args, task), None
    cfg = segtran_config(args, task)
    return build_model(cfg, task), cfg


def parse_iters(spec):
    if spec is None:
        return [None]
    if "-" in spec:
        rng, step = spec.split(",")
        lo, hi = rng.split("-")
        return list(range(int(lo), int(hi) + 1, int(step)))
    return [int(x) for x in spec.split(",")]


def nearest_downsample(gt: torch.Tensor, factors) -> torch.Tensor:
    """n-hot [H, W, D, C] downsampled by ``factors`` (one, or one per axis)
    at half-pixel centres: ``nearest-exact``, the sampling of JAX's
    ``jax.image.resize(..., 'nearest')`` (``nearest`` samples elsewhere).
    Returns [1, h, w, d, C] fp32."""
    factors = [float(f) for f in factors]
    if len(factors) == 1:
        factors = factors * 3
    small = tuple(max(int(s * f), 1) for s, f in zip(gt.shape[:3], factors))
    return F.interpolate(gt.float()[None].movedim(-1, 1), size=small,
                         mode="nearest-exact").movedim(1, -1)


def interp_probs(gt: torch.Tensor, factors) -> torch.Tensor:
    """``--testinterp``: the ground truth downsampled
    (``nearest_downsample``) and restored trilinearly (reference
    test_util3d.py:48-60)."""
    return resize_linear(nearest_downsample(gt, factors), gt.shape[:3])[0]


def ground_truth(label: np.ndarray, task_name: str, num_classes: int):
    """n-hot [H, W, D, C]: the BraTS region map, else one-hot."""
    lab = torch.from_numpy(np.ascontiguousarray(label))
    if task_name == "brats":
        return brats_map_label(lab)
    return index_to_onehot(lab, num_classes)


def evaluate_volume(model_fn, sample, args, task, device):
    """One volume: sample {'image' [H, W, D, C], 'label' [H, W, D]} ->
    (probs [H, W, D, classes] on ``device``, hard n-hot numpy,
    {metric: [per class 1..C-1]})."""
    num_classes = task["num_classes"]
    is_brats = args.task_name == "brats"
    gt = ground_truth(sample["label"], args.task_name, num_classes)
    vol = torch.from_numpy(np.ascontiguousarray(sample["image"]))[None]
    vol = vol.to(device)
    with torch.inference_mode():
        if args.test_interp:
            probs = interp_probs(gt.to(device),
                                 str(args.test_interp).split(","))
        elif args.wholevol:
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
        if is_brats:
            probs = make_brats_pred_consistent(probs)
        hard = harden_segmap(probs).cpu().numpy()
    gt = gt.numpy()
    metrics = {"dice": [], "jaccard": [], "hd95": [], "asd": []}
    for cls in range(1, num_classes):
        metrics["dice"].append(dice_score_nd(hard[..., cls], gt[..., cls]))
        metrics["jaccard"].append(jaccard_score(hard[..., cls], gt[..., cls]))
        hd, asd = surface_metrics(hard[..., cls], gt[..., cls])
        metrics["hd95"].append(hd)
        metrics["asd"].append(asd)
    return probs, hard, metrics


def _export(probs, hard, name, outdir, is_brats):
    """The raw-label prediction (BraTS labels, 3 written back as 4; else
    the hardened map's argmax) as .npz, and as .nii.gz when nibabel is
    installed; returns the .npz path."""
    if is_brats:
        inv = brats_inv_map_label(probs).cpu().numpy()
        pred_raw = inv.argmax(-1).astype(np.uint8)
        pred_raw[pred_raw == 3] = 4
    else:
        pred_raw = hard.argmax(-1).astype(np.uint8)
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
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    _refuse_later_slices(args)
    task = task_settings(args)
    logger = _logger(args.cpdir)
    log_metric_stack(logger)
    iters = parse_iters(args.iters)
    missing = [it for it in iters if it is not None and not os.path.isfile(
        os.path.join(args.cpdir, f"iter_{it}.pt"))]
    if missing:
        raise FileNotFoundError(
            f"checkpoint(s) not found under {args.cpdir}: "
            + ", ".join(f"iter_{it}.pt" for it in missing))
    dataset = make_dataset(args, task, "test", "2019valid"
                           if args.task_name == "brats" else "test")
    logger.info("%d eval volumes on %s", len(dataset), device)
    if task.get("orig_in_channels_probed"):
        logger.info("orig_in_channels probed: %d", task["orig_in_channels"])
    model, cfg = build_model_and_config(args, task)

    results = {}
    for it in iters:
        if it is None:
            if cfg is not None:
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
            probs, hard, metrics = evaluate_volume(model, sample, args, task,
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
                saved.append(_export(probs, hard, sample["name"],
                                     args.outdir, args.task_name == "brats"))
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
