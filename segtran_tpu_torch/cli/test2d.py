"""2-D evaluation of Segtran2d, U-Net and zoo checkpoints on a CUDA GPU:
checkpoint sweeps, batched sliding-window inference, per-class Dice and
vCDR, prediction export.

Counterpart of ``segtran_tpu/cli/test2d.py`` for every ``--net`` of
train2d (``segtran``, ``unet-scratch`` with ``--polyformer``, the zoo),
built by train2d's factory as JAX builds them. A DA run's checkpoint
gives its net (JAX evaluates a fresh net from one: its tolerant merge
finds no key). Per
batch of frames (``evaluate_checkpoint``), walked in order with the last
partial batch kept: the gray blend and mean/std normalisation, overlapping
``orig_input_size`` windows resized to the patch size
(``infer/sliding.py``), sigmoid, the hardened n-hot map; with masks
per-class Dice of classes 1..C-1 (reference calc_batch_metric) and with
``--vcdr`` the per-image vCDR error; with ``--outdir`` the REFUGE-format
masks (``--outorigsize``: resized back and pasted into the uncropped
frame), ``--saveprobs`` and ``pred.zip``. ``--iters`` sweeps
``iter_N.pt`` files; a missing one fails before the model is built.
Writing masks and reading frames need Pillow.

The analysis tools (``tools/``), as JAX's test2d runs them:
``--testinterp`` replaces the model by the ground truth shrunk (nearest)
and grown back (the null model's floor); ``--removefrag`` keeps the two
largest 8-connected foreground components of each prediction;
``--savefeat N`` dumps the per-pixel DA features of the first N frames
with their labels (``pixel_features.npz``); ``--flop`` logs the parameters
and the forward FLOPs and bytes of one patch; ``--vis rf`` writes the
receptive-field maps of the kept feature layers (``--vislayers``) to
``rf_maps.npz`` and ``rf_<layer>.png`` instead of evaluating; ``--robust``
logs the feature robustness of the first ``--robustsamples`` frames under
``--robustaug`` perturbations (``--robustaugdeg``; ``--robustcp`` an
``iter_N`` path for the clean features) instead of evaluating. A
checkpoint of a multi-GPU train2d run (``--ndevices``, ``--tp``, ``--ep``)
holds the full state_dict and loads as any other.

Example (GPU):
  python -m segtran_tpu_torch.cli.test2d --task fundus --ds valid \\
      --cpdir model/segtran-fundus --iters 7000,8000 --layercompress \\
      1,1,2,2 --vcdr --fusedepi --bf16 --dataroot <dataroot>
"""
from __future__ import annotations

import argparse
import os
import zipfile

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..data.labelmaps import (fundus_inv_map_mask, fundus_map_mask,
                              harden_segmap, index_to_onehot,
                              polyp_inv_map_mask, polyp_map_mask)
from ..data.pipeline import batch_iterator
from ..infer.metrics import batch_dice_per_class, log_metric_stack
from ..infer.sliding import sliding_window_2d
from ..nn.features import drop_kept_features
from ..nn.init import init_with_reference_schemes
from ..ops.losses import calc_vcdr_eval
from ..ops.resize import resize_image_linear, resize_linear
from ..tools.analysis import dump_pixel_features, layer_receptive_fields
from ..tools.flops import log_flops
from ..tools.postproc import remove_fragmentary_segs
from ..tools.robustness import eval_robustness
from ..train.checkpoint import load_checkpoint, net_state_dict
from ..utils.misc import setup_logging
from . import train2d

_GRAY_W = (0.299, 0.587, 0.114)


def parse_iters(spec):
    """"7000,8000" or "40-1600,40" (reference test2d.py:753-769)."""
    if "-" in spec:
        rng, step = spec.split(",")
        lo, hi = rng.split("-")
        return list(range(int(lo), int(hi) + 1, int(step)))
    return [int(x) for x in spec.split(",")]


def build_argparser():
    """The JAX test2d's flags, names and defaults, and ``--device``."""
    p = argparse.ArgumentParser(
        description="segtran_tpu_torch 2D evaluation (Segtran2d)")
    p.add_argument("--task", dest="task_name", default="fundus",
                   choices=["fundus", "polyp", "oct"])
    p.add_argument("--ds", dest="ds_name", default="valid")
    p.add_argument("--split", default="all")
    p.add_argument("--dataroot", default="../data")
    p.add_argument("--net", default="segtran")
    p.add_argument("--bb", dest="backbone_type", default="eff-b4")
    p.add_argument("--translayers", dest="num_translayers", type=int,
                   default=3)
    p.add_argument("--layercompress", dest="translayer_compress_ratios",
                   default=None)
    p.add_argument("--attractors", dest="num_attractors", type=int,
                   default=256)
    p.add_argument("--noqkbias", dest="qk_have_bias", action="store_false")
    p.add_argument("--nosqueeze", dest="use_squeezed_transformer",
                   action="store_false")
    p.add_argument("--pos", dest="pos_code_type", default="lsinu",
                   choices=["lsinu", "rand", "sinu", "none", "bias"])
    p.add_argument("--mince", dest="use_mince_transformer",
                   action="store_true")
    p.add_argument("--mincescales", dest="mince_scales", default=None)
    p.add_argument("--minceprops", dest="mince_channel_props", default=None)
    p.add_argument("--infpn", dest="in_fpn_layers", default="34")
    p.add_argument("--outfpn", dest="out_fpn_layers", default="1234")
    p.add_argument("--cpdir", required=True,
                   help="checkpoint dir containing iter_N.pt")
    p.add_argument("--iters", default=None,
                   help='e.g. "7000,8000" or "40-1600,40"; none: seeded '
                        'random weights')
    p.add_argument("--bs", dest="batch_size", type=int, default=8)
    p.add_argument("--origsize", dest="orig_input_size", default=None)
    p.add_argument("--patchsize", dest="patch_size", default=None)
    p.add_argument("--stats", dest="stats_json", default=None)
    p.add_argument("--gray", dest="gray_alpha", type=float, default=0.5,
                   help="grayscale blend used at training time "
                        "(must match train2d --gray)")
    p.add_argument("--saveprobs", action="store_true")
    p.add_argument("--outorigsize", dest="out_origsize", action="store_true",
                   help="save masks at the original uncropped frame size "
                        "(REFUGE submission format)")
    p.add_argument("--outdir", default=None, help="save predicted masks here")
    p.add_argument("--vcdr", dest="do_vcdr", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--scanblocks", dest="scan_blocks", action="store_true")
    p.add_argument("--fused", dest="use_fused_attention",
                   action="store_true",
                   help="CUDA flash cross-attention in the squeezed layers")
    p.add_argument("--fusedepi", dest="use_fused_epilogue",
                   action="store_true",
                   help="CUDA fused output+LN+mode-pool epilogue")
    p.add_argument("--polyformer", dest="polyformer_mode", default=None,
                   choices=[None, "source", "target"])
    p.add_argument("--testinterp", dest="test_interp", default=None)
    p.add_argument("--exclusive", dest="use_exclusive_masks",
                   action="store_true")
    p.add_argument("--removefrag", dest="do_remove_frag",
                   action="store_true")
    p.add_argument("--savefeat", dest="save_features_img_count", type=int,
                   default=0)
    p.add_argument("--modes", dest="num_modes", type=int, default=-1)
    p.add_argument("--multihead", dest="ablate_multihead",
                   action="store_true")
    p.add_argument("--attnclip", dest="attn_clip", type=float, default=500.0)
    p.add_argument("--gbias", dest="use_global_bias", action="store_true")
    p.add_argument("--inbn", dest="in_fpn_use_bn", action="store_true")
    p.add_argument("--nofeatup", dest="bb_feat_upsize", action="store_false")
    p.add_argument("--posw", dest="pos_code_weight", type=float, default=1.0)
    p.add_argument("--posr", dest="pos_bias_radius", type=int, default=7)
    p.add_argument("--squeezeuseffn", dest="has_FFN_in_squeeze",
                   action="store_true")
    p.add_argument("--verbose", action="store_true",
                   help="log per-image dice scores")
    p.add_argument("--flop", dest="do_flop_count", action="store_true")
    p.add_argument("--vis", dest="vis_mode", default=None,
                   choices=[None, "rf"])
    p.add_argument("--vislayers", dest="vis_layers", default=None)
    p.add_argument("--robust", dest="eval_robustness", action="store_true")
    p.add_argument("--robustsamples", dest="robust_sample_num", type=int,
                   default=8)
    p.add_argument("--robustaug", dest="robust_aug_types", default=None)
    p.add_argument("--robustaugdeg", dest="robust_aug_degrees",
                   default="0.5,1.5")
    p.add_argument("--robustcp", dest="robust_ref_cp_path", default=None)
    p.add_argument("--nomask", dest="has_mask", action="store_false",
                   help="predict-only mode for datasets without ground "
                        "truth")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; no GPU and no --device cpu "
                        "is an error")
    return p


def _train_args(args):
    """test2d's flags over train2d's defaults, in eval form: no dropout,
    the training-only flags at their defaults."""
    defaults = vars(train2d.build_argparser().parse_args([]))
    return argparse.Namespace(**{**defaults, **vars(args),
                                 "dropout_prob": 0.0, "remat_blocks": False})


def _refuse_later_slices(args) -> None:
    train2d._refuse_later_slices(_train_args(args))


def build_model(args, task):
    """train2d's factory in eval form (``_train_args``)."""
    return train2d.build_model_and_config(_train_args(args), task)


def make_model_fn(model, mean, std, gray_alpha, device):
    """[N, h, w, 3] frames in [0, 1] -> the model's logits, after the gray
    blend and the mean/std normalisation of training."""
    f32 = dict(dtype=torch.float32, device=device)
    gray_w = torch.tensor(_GRAY_W, **f32)
    mean_t, std_t = torch.tensor(mean, **f32), torch.tensor(std, **f32)

    def model_fn(image):
        gray = torch.tensordot(image, gray_w, dims=([-1], [0]))[..., None]
        x = (1 - gray_alpha) * image + gray_alpha * gray
        return model((x - mean_t) / std_t)
    return model_fn


def _save_masks(hard, batch, dataset, args, saved, probs):
    """The batch's REFUGE-format masks (and probabilities) under
    --outdir."""
    from PIL import Image
    os.makedirs(args.outdir, exist_ok=True)
    # the non-fundus tasks' encoding (JAX test2d.py:317-318)
    inv = (fundus_inv_map_mask if args.task_name == "fundus"
           else polyp_inv_map_mask)
    raw = inv(hard).cpu().numpy()
    for i, idx in enumerate(batch["index"]):
        name = os.path.basename(dataset.image_list[int(idx)])
        out_path = os.path.join(args.outdir, name)
        pred = raw[i]
        if args.out_origsize:
            # resize back to the crop's size and paste it at crop_pos in
            # the uncropped frame (reference test_util2d.py:121-132)
            h0, w0 = (int(x) for x in batch["unscaled_size"][i])
            pred = np.asarray(Image.fromarray(pred).resize((w0, h0),
                                                           Image.NEAREST))
            unc = np.asarray(batch["uncropped_size"][i]).reshape(-1)
            if unc.size == 2 and int(unc[0]) > 0:
                cx, cy = (int(x) for x in batch["crop_pos"][i])
                bg = 255 if args.task_name == "fundus" else 0
                canvas = np.full((int(unc[0]), int(unc[1])), bg, np.uint8)
                canvas[cx:cx + h0, cy:cy + w0] = pred
                pred = canvas
        Image.fromarray(pred).save(out_path)
        saved.append(out_path)
        if args.saveprobs:
            np.save(out_path + ".probs.npy",
                    probs[i].cpu().numpy().astype(np.float16))


def _zip(saved, outdir, log):
    zpath = os.path.join(outdir, "pred.zip")
    with zipfile.ZipFile(zpath, "w") as z:
        for pth in saved:
            z.write(pth, os.path.basename(pth))
    log.info("zipped %d masks -> %s", len(saved), zpath)


def _interp_probs(args, task, raw):
    """--testinterp: the ground truth shrunk to the given size (nearest,
    half-pixel) and grown back by ``resize_linear`` (reference
    test_util2d.py:60-64)."""
    ti = tuple(int(v) for v in str(args.test_interp).split(","))
    ti = ti * 2 if len(ti) == 1 else ti
    if args.task_name == "fundus":
        gt = fundus_map_mask(raw)
    elif args.task_name == "polyp":
        gt = polyp_map_mask(raw)
    else:
        gt = index_to_onehot(raw[..., 0], task["num_classes"])
    small = F.interpolate(gt.movedim(-1, 1), size=ti,
                          mode="nearest-exact").movedim(1, -1)
    return resize_linear(small, gt.shape[1:3])


def _remove_fragments(hard):
    """--removefrag: per frame, the foreground outside the two largest
    8-connected components cleared (reference test2d.py:654-656)."""
    hard_np = hard.cpu().numpy().copy()
    for i in range(hard_np.shape[0]):
        fg = hard_np[i, :, :, 1:].any(-1).astype(np.uint8)
        kept = remove_fragmentary_segs(fg, keep_top=2) > 0
        hard_np[i, :, :, 1:] = hard_np[i, :, :, 1:] * kept[..., None]
        hard_np[i, :, :, 0] = 1 - hard_np[i, :, :, 1:].max(-1)
    return torch.from_numpy(hard_np).to(hard.device)


def _pixel_features(model, model_fn, img, raw, args, task, patch):
    """--savefeat: the DA feature of the frames at the patch size
    [B, h2, w2, C] and their labels on its grid [B, h2, w2] (the
    reference's feature_maps[-1], test_util2d.py:78-88)."""
    model.keep_features = True
    try:
        model_fn(resize_linear(img, patch))
        feats = train2d._da_feature(model).float().cpu().numpy()
    finally:
        model.keep_features = False
        drop_kept_features(model)
    gt_ex = (fundus_map_mask(raw, exclusive=True)
             if args.task_name == "fundus" else train2d.map_mask(args, task,
                                                                raw))
    lab = resize_linear(gt_ex.float(), feats.shape[1:3])
    return feats, (lab >= 0.5).int().argmax(-1).cpu().numpy()


def evaluate_checkpoint(model, dataset, task, args, log, mean, std,
                        device=None):
    """One pass over ``dataset`` with ``model`` (weights loaded, in eval
    mode). Returns the mean per-class Dice of classes 1..C-1, with the
    mean vCDR error appended under --vcdr (the reference's metric layout),
    or zeros when the frames have no masks. The forward is built for this
    call only. --testinterp, --removefrag and --savefeat act here."""
    device = device or next(model.parameters()).device
    num_classes = task["num_classes"]
    orig, patch = tuple(task["orig_input_size"]), tuple(task["patch_size"])
    model_fn = make_model_fn(model, mean, std, args.gray_alpha, device)
    has_mask = getattr(args, "has_mask", True)
    feat_budget = getattr(args, "save_features_img_count", 0)
    all_dice, all_vcdr_err, saved = [], [], []
    feats_acc, labels_acc = [], []
    for batch in batch_iterator(dataset, args.batch_size, epoch=0,
                                shuffle=False, drop_last=False,
                                keys=("image", "mask", "index", "crop_pos",
                                      "unscaled_size", "uncropped_size")):
        img = torch.from_numpy(batch["image"]).to(device)
        raw = torch.from_numpy(batch["mask"]).to(device)
        with torch.inference_mode():
            if getattr(args, "test_interp", None):
                probs = _interp_probs(args, task, raw)
            else:
                probs = sliding_window_2d(model_fn, img, orig, patch,
                                          num_classes=num_classes)
            gt = train2d.map_mask(args, task, raw)
            hard = harden_segmap(probs)
            if getattr(args, "do_remove_frag", False):
                hard = _remove_fragments(hard)
            if len(feats_acc) < feat_budget:
                feats, lab = _pixel_features(model, model_fn, img, raw, args,
                                             task, patch)
                take = feat_budget - len(feats_acc)
                feats_acc.extend(feats[:take])
                labels_acc.extend(lab[:take])
            if has_mask:
                dice = batch_dice_per_class(hard.float(), gt, num_classes)
                all_dice.append(dice.cpu().numpy())
                if args.verbose:
                    for i, idx in enumerate(batch["index"]):
                        log.info("%s: dice %s", os.path.basename(
                            dataset.image_list[int(idx)]),
                            np.round(all_dice[-1][i], 4))
            if has_mask and args.do_vcdr and num_classes >= 3:
                # per image, as the reference eval computes it
                verr = (calc_vcdr_eval(gt)
                        - calc_vcdr_eval(hard.float())).abs()
                all_vcdr_err.append(verr.cpu().numpy())
        if args.outdir:
            _save_masks(hard, batch, dataset, args, saved, probs)
    if feats_acc:
        fdir = args.outdir or args.cpdir
        os.makedirs(fdir, exist_ok=True)
        fpath = os.path.join(fdir, "pixel_features.npz")
        dump_pixel_features(np.stack(feats_acc), np.stack(labels_acc), fpath)
        log.info("saved pixel features of %d images -> %s", len(feats_acc),
                 fpath)
    if not all_dice:
        log.info("predict-only mode: no ground truth, no Dice")
        if args.outdir and saved:
            _zip(saved, args.outdir, log)
        return np.zeros(num_classes - 1)
    cls_dice = np.concatenate(all_dice, 0).mean(0)
    for c, d in enumerate(cls_dice):
        log.info("class %d dice: %.4f", c + 1, d)
    log.info("avg dice: %.4f", cls_dice.mean())
    if all_vcdr_err:
        vcdr_err = float(np.concatenate(all_vcdr_err).mean())
        log.info("vCDR error: %.4f", vcdr_err)
        cls_dice = np.concatenate([cls_dice, [vcdr_err]])
    if args.outdir and saved:
        _zip(saved, args.outdir, log)
    return cls_dice


def _receptive_fields(model, patch, args, log):
    """--vis rf: the kept layers' receptive-field maps as rf_maps.npz and
    rf_<layer>.png under --outdir (else --cpdir)."""
    from PIL import Image
    sel = ([int(v) for v in str(args.vis_layers).split(",")]
           if args.vis_layers else None)
    maps = layer_receptive_fields(model, patch + (3,), sel)
    vis_dir = args.outdir or args.cpdir
    os.makedirs(vis_dir, exist_ok=True)
    np.savez_compressed(os.path.join(vis_dir, "rf_maps.npz"), **maps)
    for name, m in maps.items():
        mm = m / (m.max() + 1e-12)
        Image.fromarray((mm * 255).astype(np.uint8)).save(
            os.path.join(vis_dir, f"rf_{name}.png"))
        centre = m[m.shape[0] // 4:-m.shape[0] // 4 or None,
                   m.shape[1] // 4:-m.shape[1] // 4 or None]
        log.info("rf[%s]: %s, mass within center quarter %.3f", name,
                 m.shape, float(centre.sum() / (m.sum() + 1e-12)))
    return maps


def _robustness(model, dataset, patch, cfg, args, log, device):
    """--robust: eval_robustness on the first --robustsamples frames
    resized to the patch size (antialiased, as jax.image.resize)."""
    n = min(args.robust_sample_num, len(dataset))
    imgs = torch.stack([torch.as_tensor(np.asarray(dataset[i]["image"]))
                        for i in range(n)]).float().to(device)
    imgs = resize_image_linear(imgs, patch)
    ref_state = None
    if args.robust_ref_cp_path:
        ref_state = {k: v.to(device) for k, v in net_state_dict(
            load_checkpoint(args.robust_ref_cp_path, cfg)).items()}
    kw = {}
    if args.robust_aug_types:
        kw["perturbations"] = [t for t in args.robust_aug_types.split(",")
                               if t]
    deg = tuple(float(v) for v in str(args.robust_aug_degrees).split(","))
    rob = eval_robustness(model, imgs, degrees=deg * 2 if len(deg) == 1
                          else deg, ref_state_dict=ref_state, **kw)
    for pert, vals in rob.items():
        log.info("robustness[%s]: output_pearson=%.4f", pert,
                 vals["output_pearson"])
        for k, v in sorted(vals.items()):
            if k != "output_pearson" and not k.startswith(("lr_", "std/")):
                log.info("  %s: %.4f", k, v)
    return rob


def _logger(log_dir):
    return setup_logging(log_dir, "eval_log.txt", "segtran_tpu_torch.test2d")


def main(argv=None):
    """Returns {iteration: evaluate_checkpoint's result}."""
    from ..data.datasets2d import SegCrop, SegWhole
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    _refuse_later_slices(args)
    task = train2d.task_settings(args)
    log = _logger(args.cpdir)
    log_metric_stack(log)
    # a missing checkpoint fails before the model is built
    iters = parse_iters(args.iters) if args.iters else [None]
    missing = [it for it in iters if it is not None and not os.path.isfile(
        os.path.join(args.cpdir, f"iter_{it}.pt"))]
    if missing:
        raise FileNotFoundError(
            f"checkpoint(s) not found under {args.cpdir}: "
            + ", ".join(f"iter_{it}.pt" for it in missing))
    ds_cls = {"SegCrop": SegCrop, "SegWhole": SegWhole}[task["ds_class"]]
    dataset = ds_cls(
        base_dir=os.path.join(args.dataroot, args.task_name, args.ds_name),
        split=args.split, mask_num_classes=task["num_classes"],
        has_mask=args.has_mask and task.get("has_mask", {}).get(
            args.ds_name, True),
        uncropped_size=task.get("uncropped_size", {}).get(args.ds_name, -1),
        binarize=task.get("binarize", False),
        out_size=task["orig_input_size"])
    args.has_mask = dataset.has_mask
    log.info("%d eval samples on %s", len(dataset), device)
    mean, std = train2d.load_stats(args, args.ds_name)
    model, cfg = build_model(args, task)
    patch = tuple(task["patch_size"])
    if args.do_flop_count:
        log_flops(model.to(device).eval(), (1,) + patch + (3,), log,
                  "GFLOPs/img")
    results = {}
    for it in iters:
        if it is None:
            init_with_reference_schemes(model, cfg, seed=0)
        else:
            model.load_state_dict(net_state_dict(load_checkpoint(
                os.path.join(args.cpdir, f"iter_{it}"), cfg)), strict=True)
            log.info("=== iter %d ===", it)
        model = model.to(device).eval()
        if args.vis_mode == "rf":
            results[it] = _receptive_fields(model, patch, args, log)
        elif args.eval_robustness:
            results[it] = _robustness(model, dataset, patch, cfg, args, log,
                                      device)
        else:
            results[it] = evaluate_checkpoint(model, dataset, task, args,
                                              log, mean, std, device)
    return results


if __name__ == "__main__":
    main()
