"""2-D training of Segtran2d on a CUDA GPU (REFUGE fundus, polyp, OCT).

Counterpart of ``segtran_tpu/cli/train2d.py`` for ``--net segtran``,
supervised. Per step (``make_step``) on the device: the task's label map
of the raw masks, the batched 2-D augmentation (``data/augment.py``:
crop-and-pad ``--randscale``, flips, quarter turns, ``--affine``, the
gray blend ``--gray``, the colour jitter, ``--robustaug``, normalisation
by the dataset's mean/std table, per sample in a multi-``--ds`` run), a
bilinear resize to the patch size; then the forward in training mode,
(1 - w) weighted BCE + w class-weighted Dice (``--diceweight``,
``--focus``), the global-norm clip and BertAdam with warmup-linear over
the reference's parameter groups, with ``--gradaccum`` microbatches.
``--fused`` runs the CUDA flash attention in the squeezed layers when
``--dropout 0``. The model options of the paper's ablations build as JAX
builds them: ``--nosqueeze``, ``--pos rand|sinu|bias`` (``--posr``,
``--posw``), ``--multihead``, ``--inbn``, ``--gbias``, and ``--outfpn``
equal to ``--infpn`` (no output FPN). Checkpoints ``iter_N.pt`` with
their sidecar every ``--saveiter`` iterations and at the end; ``--cp``
starts from one.
Flags whose modules belong to a later slice of the port raise
NotImplementedError naming the ROADMAP item that will port them.

Example (GPU; reading the PNG frames needs Pillow):
  python -m segtran_tpu_torch.cli.train2d --task fundus --translayers 3 \\
      --layercompress 1,1,2,2 --net segtran --bb eff-b4 --maxiter 10000 \\
      --bs 6 --noqkbias --bf16 --dataroot <dataroot>
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import Segtran2dConfig
from ..configs.presets import NET_SETTINGS, TASK_SETTINGS
from ..data.augment import Aug2dConfig, augment_batch_2d, draw_2d
from ..data.labelmaps import fundus_map_mask, index_to_onehot, polyp_map_mask
from ..data.pipeline import DevicePrefetcher, batch_iterator
from ..data.stats import load_dataset_stats
from ..models.segtran2d import Segtran2d
from ..nn.attention import set_dropout_generator
from ..nn.init import init_with_reference_schemes
from ..ops.resize import resize_linear
from ..train.checkpoint import load_checkpoint, save_checkpoint
from ..train.trainer import (build_optimizer, make_loss_fn, make_train_step,
                             resolve_remat_blocks)
from ..utils.meters import AverageMeters

logger = logging.getLogger("segtran_tpu_torch.train2d")


def build_argparser() -> argparse.ArgumentParser:
    """The JAX train2d's flags, names and defaults, and ``--device``."""
    p = argparse.ArgumentParser(
        description="segtran_tpu_torch 2D training (Segtran2d)")
    p.add_argument("--task", dest="task_name", default="fundus",
                   choices=["fundus", "polyp", "oct"])
    p.add_argument("--ds", dest="ds_names", default=None,
                   help="comma-separated dataset names")
    p.add_argument("--split", default="train", choices=["train", "all"])
    p.add_argument("--dataroot", default="../data")
    p.add_argument("--net", default="segtran")
    p.add_argument("--bb", dest="backbone_type", default="eff-b4")
    p.add_argument("--translayers", dest="num_translayers", type=int,
                   default=3)
    p.add_argument("--layercompress", dest="translayer_compress_ratios",
                   default=None, help="e.g. 1,1,2,2")
    p.add_argument("--attractors", dest="num_attractors", type=int,
                   default=256)
    p.add_argument("--modes", dest="num_modes", type=int, default=-1)
    p.add_argument("--dropout", dest="dropout_prob", type=float, default=-1)
    p.add_argument("--noqkbias", dest="qk_have_bias", action="store_false")
    p.add_argument("--nosqueeze", dest="use_squeezed_transformer",
                   action="store_false")
    p.add_argument("--pos", dest="pos_code_type", default="lsinu",
                   choices=["lsinu", "rand", "sinu", "none", "bias"])
    p.add_argument("--multihead", dest="ablate_multihead",
                   action="store_true")
    p.add_argument("--mince", dest="use_mince_transformer",
                   action="store_true")
    p.add_argument("--mincescales", dest="mince_scales", default=None)
    p.add_argument("--minceprops", dest="mince_channel_props", default=None)
    p.add_argument("--infpn", dest="in_fpn_layers", default="34")
    p.add_argument("--outfpn", dest="out_fpn_layers", default="1234")
    p.add_argument("--maxiter", type=int, default=10000)
    p.add_argument("--saveiter", type=int, default=500)
    p.add_argument("--logiter", type=lambda v: max(int(v), 1), default=50,
                   help="log running loss averages every N iters (min 1)")
    p.add_argument("--bs", dest="batch_size", type=int, default=6)
    p.add_argument("--lr", type=float, default=-1)
    p.add_argument("--decay", type=float, default=-1)
    p.add_argument("--gradclip", dest="grad_clip", type=float, default=-1)
    p.add_argument("--lrwarmup", dest="lr_warmup_steps", type=int,
                   default=500)
    p.add_argument("--diceweight", dest="max_dice_w", type=float, default=0.5)
    p.add_argument("--focus", dest="focus_class", type=int, default=-1)
    p.add_argument("--randscale", type=float, default=0.2)
    p.add_argument("--affine", dest="do_affine", action="store_true")
    p.add_argument("--gray", dest="gray_alpha", type=float, default=0.5)
    p.add_argument("--stats", dest="stats_json", default=None,
                   help="dataset mean/std JSON (reference format)")
    p.add_argument("--polyformer", dest="polyformer_mode", default=None,
                   choices=[None, "source", "target"])
    p.add_argument("--adv", dest="adversarial_mode", default=None,
                   choices=[None, "feat", "mask"])
    p.add_argument("--sourceds", dest="source_ds_name", default="train")
    p.add_argument("--domweight", dest="domain_loss_w", type=float,
                   default=0.002)
    p.add_argument("--adda", action="store_true")
    p.add_argument("--reconweight", dest="recon_w", type=float, default=0.0)
    p.add_argument("--attnclip", dest="attn_clip", type=float, default=500.0)
    p.add_argument("--gbias", dest="use_global_bias", action="store_true")
    p.add_argument("--inbn", dest="in_fpn_use_bn", action="store_true")
    p.add_argument("--outdrop", dest="out_fpn_do_dropout",
                   action="store_true")
    p.add_argument("--nofeatup", dest="bb_feat_upsize", action="store_false")
    p.add_argument("--posw", dest="pos_code_weight", type=float, default=1.0)
    p.add_argument("--posr", dest="pos_bias_radius", type=int, default=7)
    p.add_argument("--squeezeuseffn", dest="has_FFN_in_squeeze",
                   action="store_true")
    p.add_argument("--locprob", dest="localization_prob", type=float,
                   default=0.0,
                   help="probability of the mask-guided localisation crop "
                        "at load")
    p.add_argument("--exclusive", dest="use_exclusive_masks",
                   action="store_true")
    p.add_argument("--supweight", dest="supervised_w", type=float,
                   default=1.0)
    p.add_argument("--sourcebs", dest="source_batch_size", type=int,
                   default=-1)
    p.add_argument("--optfilter", dest="opt_filters", default=None)
    p.add_argument("--opt", dest="opt_name", default="bertadam",
                   choices=["bertadam", "adamw", "sgd", "adam"],
                   help="optimizer (adamw == bertadam)")
    p.add_argument("--tunebn", dest="tune_bn_only", action="store_true")
    p.add_argument("--robustaug", dest="robust_aug_types", default=None,
                   help="'brightness' and/or 'contrast', comma-separated")
    p.add_argument("--robustaugdeg", dest="robust_aug_degrees",
                   default="0.5,1.5")
    p.add_argument("--reshape", dest="reshape_mask_type", default=None,
                   choices=[None, "rectangle"])
    p.add_argument("--attndiag", dest="attn_diag_cycles", type=int,
                   default=0)
    p.add_argument("--attnconsist", dest="use_attn_consist_loss",
                   action="store_true")
    p.add_argument("--attnconsistweight", dest="attn_consist_w", type=float,
                   default=0.01)
    p.add_argument("--vcdr", dest="vcdr_estim_scheme", default="none",
                   choices=["none", "single", "sep"])
    p.add_argument("--vcdrweight", dest="vcdr_w", type=float, default=0.01)
    p.add_argument("--vcdrestimstart", dest="vcdr_estim_start", type=int,
                   default=1000)
    p.add_argument("--vcdrnetstart", dest="vcdr_net_start", type=int,
                   default=1100)
    p.add_argument("--contrastweight", dest="contrast_loss_w", type=float,
                   default=0.0)
    p.add_argument("--reffeatcp", dest="ref_feat_cp_path", default=None)
    p.add_argument("--numreffeat", dest="num_ref_features", type=int,
                   default=1000)
    p.add_argument("--numcontrastfeat", dest="num_contrast_features",
                   type=int, default=500)
    p.add_argument("--refclasses", dest="selected_ref_classes", default=None)
    p.add_argument("--negcontrast", dest="do_neg_contrast",
                   action="store_true")
    p.add_argument("--sourceopt", dest="poly_source_opt", default="allpoly")
    p.add_argument("--targetopt", dest="poly_target_opt", default="k")
    p.add_argument("--bnopt", dest="bn_opt_scheme", default=None,
                   choices=[None, "affine", "fixstats"])
    p.add_argument("--sample", dest="sample_num", type=int, default=-1,
                   help="few-shot: number of training shots")
    p.add_argument("--cp", dest="checkpoint_path", default=None,
                   help="start from <dir>/iter_N(.pt)")
    p.add_argument("--ckptdir", default="./model")
    p.add_argument("--origsize", dest="orig_input_size", default=None,
                   help="override task orig_input_size, e.g. 576 or 576,576")
    p.add_argument("--patchsize", dest="patch_size", default=None,
                   help="override task patch_size (model input)")
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--ndevices", type=int, default=-1)
    p.add_argument("--tp", dest="tensor_parallel", type=int, default=1)
    p.add_argument("--ep", dest="expert_parallel", action="store_true")
    p.add_argument("--fused", dest="use_fused_attention",
                   action="store_true",
                   help="CUDA flash attention forward + backward in the "
                        "squeezed layers (with --dropout 0)")
    p.add_argument("--fusedepi", dest="use_fused_epilogue",
                   action="store_true",
                   help="CUDA fused epilogue (eval only; inert in training)")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--remat", action="store_true")
    g = p.add_mutually_exclusive_group()
    g.add_argument("--rematblocks", dest="remat_blocks",
                   action="store_true", default=None)
    g.add_argument("--norematblocks", dest="remat_blocks",
                   action="store_false",
                   help="default: on below a per-device microbatch of 12 "
                        "(resolve_remat_blocks)")
    p.add_argument("--gradaccum", dest="grad_accum", type=int, default=1)
    p.add_argument("--scanblocks", dest="scan_blocks", action="store_true")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; no GPU and no --device cpu "
                        "is an error")
    return p


_DA = "ROADMAP Queue 1 item 5: 2.5D, DA and Polyformer"
_ZOO = "ROADMAP Queue 1 item 6: the zoo, parallel/ and tools"


def _refuse_later_slices(args) -> None:
    later = [
        (args.adversarial_mode is not None, "--adv", _DA),
        (args.source_ds_name != "train", "--sourceds", _DA),
        (args.adda, "--adda", _DA),
        (args.recon_w > 0, "--reconweight", _DA),
        (args.vcdr_estim_scheme != "none", "--vcdr", _DA),
        (args.contrast_loss_w > 0, "--contrastweight", _DA),
        (args.ref_feat_cp_path is not None, "--reffeatcp", _DA),
        (args.use_attn_consist_loss, "--attnconsist", _DA),
        (args.attn_diag_cycles > 0, "--attndiag", _DA),
        (args.polyformer_mode is not None, "--polyformer", _DA),
        (args.tune_bn_only, "--tunebn", _DA),
        (args.opt_name in ("sgd", "adam"), f"--opt {args.opt_name}", _ZOO),
        (args.opt_filters is not None, "--optfilter", _ZOO),
        (args.tensor_parallel > 1 or args.expert_parallel
         or args.ndevices > 1, "--tp/--ep/--ndevices above 1", _ZOO),
        (args.net != "segtran", f"--net {args.net}", _ZOO),
        (args.use_mince_transformer, "--mince", _DA),
        (args.profile, "--profile", _ZOO),
    ]
    for bad, flag, where in later:
        if bad:
            raise NotImplementedError(
                f"{flag} is not ported yet: it belongs to a later slice of "
                f"the PyTorch port ({where})")
    if args.scan_blocks:
        raise NotImplementedError(
            "--scanblocks is not ported: it is a TPU compile-time "
            "workaround, left out of the PyTorch port (ROADMAP 'Leave out')")


def task_settings(args):
    """TASK_SETTINGS[--task] with --origsize / --patchsize applied."""
    task = dict(TASK_SETTINGS[args.task_name])
    for field, override in (("orig_input_size", args.orig_input_size),
                            ("patch_size", args.patch_size)):
        if override:
            vals = tuple(int(v) for v in str(override).split(","))
            task[field] = vals * 2 if len(vals) == 1 else vals
    return task


def dataset_names(args, task):
    return (args.ds_names.split(",") if args.ds_names
            else list(task["ds_names"]))


def load_stats(args, ds_name):
    """Normalisation (mean, std) of one dataset, chosen by task and --gray
    (reference train2d.py:406-414); --stats overrides."""
    return load_dataset_stats(args.task_name, args.gray_alpha, ds_name,
                              stats_json=args.stats_json)


def build_model_and_config(args, task):
    """``--net segtran`` in training form (JAX train2d.py:313-356). An
    unset --rematblocks/--norematblocks takes ``resolve_remat_blocks``."""
    _refuse_later_slices(args)
    if args.remat_blocks is None:
        args.remat_blocks, mb = resolve_remat_blocks(
            args.batch_size, args.grad_accum, 1, 1)
        logger.info("remat_blocks auto -> %s (microbatch %d; force with "
                    "--rematblocks/--norematblocks)", args.remat_blocks, mb)
    net_set = NET_SETTINGS["segtran"]
    num_modes = args.num_modes if args.num_modes != -1 else \
        net_set["num_modes"].get(args.in_fpn_layers, 4)
    dropout = args.dropout_prob if args.dropout_prob >= 0 else \
        net_set["dropout_prob"].get(args.in_fpn_layers, 0.2)
    compress = tuple(float(x) for x in (
        args.translayer_compress_ratios
        or ",".join(["1"] * (args.num_translayers + 1))).split(","))
    cfg = Segtran2dConfig(
        backbone_type=args.backbone_type,
        num_classes=task["num_classes"],
        num_attractors=args.num_attractors,
        num_modes=num_modes,
        qk_have_bias=args.qk_have_bias,
        use_squeezed_transformer=args.use_squeezed_transformer,
        ablate_multihead=args.ablate_multihead,
        attn_clip=args.attn_clip,
        use_global_bias=args.use_global_bias,
        in_fpn_use_bn=args.in_fpn_use_bn,
        out_fpn_do_dropout=args.out_fpn_do_dropout,
        bb_feat_upsize=args.bb_feat_upsize,
        pos_code_weight=args.pos_code_weight,
        pos_bias_radius=args.pos_bias_radius,
        has_FFN_in_squeeze=args.has_FFN_in_squeeze,
        use_fused_attention=args.use_fused_attention,
        use_fused_epilogue=args.use_fused_epilogue,
        remat=args.remat,
        remat_blocks=bool(args.remat_blocks),
        pos_code_type=args.pos_code_type,
        in_fpn_layers=tuple(int(c) for c in args.in_fpn_layers),
        out_fpn_layers=tuple(int(c) for c in args.out_fpn_layers),
        hidden_dropout_prob=dropout,
        attention_probs_dropout_prob=dropout,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
    ).derive(translayer_compress_ratios=compress)
    if args.use_fused_attention and dropout > 0:
        logger.warning("--fused is inert during training with attention "
                       "dropout %.2f; pass --dropout 0 to engage the flash "
                       "kernels", dropout)
    return Segtran2d(cfg, patch_size=task["patch_size"]), cfg


def optimizer_settings(args):
    """(lr, decay, grad_clip): the flags where set, else --net's preset."""
    net_set = NET_SETTINGS[args.net]
    return (args.lr if args.lr > 0 else net_set["lr"],
            args.decay if args.decay >= 0 else net_set["decay"],
            args.grad_clip if args.grad_clip > 0 else net_set["grad_clip"])


def aug_config(args, mean, std) -> Aug2dConfig:
    rdeg = tuple(float(v) for v in str(args.robust_aug_degrees).split(","))
    return Aug2dConfig(
        randscale=args.randscale, gray_alpha=args.gray_alpha,
        do_affine=args.do_affine,
        robust_aug=tuple(t for t in str(args.robust_aug_types or "")
                         .split(",") if t),
        robust_aug_range=rdeg * 2 if len(rdeg) == 1 else rdeg,
        mean=tuple(mean), std=tuple(std))


def map_mask(args, task, raw):
    """The task's n-hot label map of raw uint8 masks [B, H, W, C]."""
    if args.task_name == "fundus":
        return fundus_map_mask(raw, exclusive=args.use_exclusive_masks)
    if args.task_name == "polyp":
        return polyp_map_mask(raw)
    return index_to_onehot(raw[..., 0], task["num_classes"])


def make_step(model, optimizer, args, task, device, ds_stats=None):
    """step(batch {'image' [B, H, W, 3] float in [0, 1], 'mask' [B, H, W,
    C] raw uint8, and with ``ds_stats`` 'ds_idx' [B]} on the device,
    draws=None) -> metrics. The augmentation draws come from a generator
    on the device seeded with --seed (which the model's dropout shares)
    unless ``draws`` (``data/augment.draw_2d``) gives them. ``ds_stats``:
    (mean [D, C], std [D, C]) of a multi-dataset run, indexed per sample
    by 'ds_idx' (reference train_util.py:100-106)."""
    mean, std = load_stats(args, dataset_names(args, task)[0])
    cfg = aug_config(args, mean, std)
    patch = tuple(task["patch_size"])
    loss_fn = make_loss_fn(task["num_classes"], task["bce_weight"],
                           dice_w=args.max_dice_w,
                           focus_class=args.focus_class)
    if args.supervised_w != 1.0:
        unscaled = loss_fn

        def loss_fn(logits, mask):
            loss, metrics = unscaled(logits, mask)
            loss = args.supervised_w * loss
            return loss, dict(metrics, loss=loss)
    base = make_train_step(model, optimizer, loss_fn,
                           grad_accum=max(1, args.grad_accum),
                           grad_clip=optimizer_settings(args)[2])
    gen = torch.Generator(device=device).manual_seed(args.seed)
    set_dropout_generator(model, gen)
    if ds_stats is not None:
        ds_stats = tuple(torch.as_tensor(np.asarray(t, np.float32),
                                         device=device) for t in ds_stats)

    def augment(batch, draws=None):
        image = batch["image"]
        mask = map_mask(args, task, batch["mask"])
        draws = draw_2d(image.shape[0], cfg, gen) if draws is None else draws
        mu = sd = None
        if ds_stats is not None and "ds_idx" in batch:
            idx = batch["ds_idx"].long()
            mu, sd = ds_stats[0][idx], ds_stats[1][idx]
        image, mask = augment_batch_2d(image, mask, draws, cfg, mu, sd)
        return {"image": resize_linear(image, patch), "mask": mask}

    def step(batch, draws=None):
        return base(augment(batch, draws))

    step.augment = augment
    return step


def _logger(log_dir):
    os.makedirs(log_dir, exist_ok=True)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("[%(asctime)s] %(message)s", "%H:%M:%S")
    for h in (logging.FileHandler(os.path.join(log_dir, "train2d_log.txt")),
              logging.StreamHandler(sys.stdout)):
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


def job_dir(args, task) -> str:
    return os.path.join(args.ckptdir, f"{args.net}-{args.task_name}-"
                        f"{','.join(dataset_names(args, task))}-"
                        f"{time.strftime('%m%d%H%M')}")


def _summary_writer(log_dir):
    """TensorBoard's writer where the package imports, else None."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir)


def train(model, dataset, args, task, device, cfg=None, ckpt_dir=None,
          log=None):
    """Train ``model`` (initialised, on ``device``) on any dataset of the
    ``data/datasets2d.py`` schema for --maxiter steps; returns the
    checkpoint directory. A multi-``--ds`` run normalises each sample with
    its dataset's table through the samples' 'ds_idx'."""
    ckpt_dir = ckpt_dir or job_dir(args, task)
    log = log or _logger(ckpt_dir)
    if args.grad_accum > 1 and args.batch_size % args.grad_accum:
        raise ValueError(f"--gradaccum {args.grad_accum} must divide --bs "
                         f"{args.batch_size}")
    names = dataset_names(args, task)
    ds_stats = None
    if len(names) > 1:
        stats = [load_stats(args, n) for n in names]
        ds_stats = ([s[0] for s in stats], [s[1] for s in stats])
        for n, (m, s) in zip(names, stats):
            log.info("normalization stats for %s: mean=%s std=%s", n, m, s)
    lr, decay, _ = optimizer_settings(args)
    warmup_ratio = min(args.lr_warmup_steps, args.maxiter // 2) / args.maxiter
    optimizer = build_optimizer(model, lr=lr, decay=decay,
                                t_total=args.maxiter,
                                warmup_ratio=warmup_ratio)
    step = make_step(model, optimizer, args, task, device, ds_stats)
    keys = ("image", "mask") + (("ds_idx",) if ds_stats else ())
    writer = _summary_writer(os.path.join(ckpt_dir, "log"))
    meters = AverageMeters()
    iter_num, epoch, t0 = 0, 0, time.time()
    try:
        while iter_num < args.maxiter:
            loader = DevicePrefetcher(batch_iterator(
                dataset, args.batch_size, epoch, seed=args.seed, keys=keys),
                device)
            try:
                for batch in loader:
                    metrics = step(batch)
                    iter_num += 1
                    values = torch.stack(list(metrics.values())).tolist()
                    for k, v in zip(metrics, values):
                        meters.update(k, v)
                        if writer is not None:
                            writer.add_scalar(k, v, iter_num)
                    if iter_num == 1:
                        log.info("first step done in %.1fs",
                                 time.time() - t0)
                    if iter_num % args.logiter == 0:
                        log.info("iter %d (%.2f it/s): %s", iter_num,
                                 iter_num / (time.time() - t0),
                                 meters.disp_str(("loss", "ce_loss",
                                                  "dice_loss")))
                        meters.reset_disp()
                    if (iter_num % args.saveiter == 0
                            or iter_num >= args.maxiter):
                        save_checkpoint(ckpt_dir, iter_num,
                                        model.state_dict(), cfg)
                        log.info("saved iter_%d", iter_num)
                    if iter_num >= args.maxiter:
                        break
            finally:
                loader.close()
            epoch += 1
    finally:
        if writer is not None:
            writer.close()
    log.info("done: %d iters in %.1fs", iter_num, time.time() - t0)
    return ckpt_dir


def build_datasets(args, task):
    """One SegCrop/SegWhole per --ds name; a ConcatDataset of them for
    more than one."""
    from ..data.datasets2d import ConcatDataset, SegCrop, SegWhole
    ds_cls = {"SegCrop": SegCrop, "SegWhole": SegWhole}[task["ds_class"]]
    datasets = [ds_cls(
        base_dir=os.path.join(args.dataroot, args.task_name, name),
        split=args.split, sample_num=args.sample_num,
        mask_num_classes=task["num_classes"],
        binarize=task.get("binarize", False),
        has_mask=task.get("has_mask", {}).get(name, True),
        ds_weight=task.get("ds_weight", {}).get(name, 1.0),
        uncropped_size=task.get("uncropped_size", {}).get(name, -1),
        reshape_mask_type=args.reshape_mask_type,
        train_loc_prob=args.localization_prob,
        min_output_size=task["orig_input_size"],
        out_size=task["orig_input_size"], seed=args.seed)
        for name in dataset_names(args, task)]
    return ConcatDataset(datasets) if len(datasets) > 1 else datasets[0]


def main(argv=None):
    """Returns the checkpoint directory."""
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    _refuse_later_slices(args)
    if args.grad_accum > 1 and args.batch_size % args.grad_accum:
        raise ValueError(f"--gradaccum {args.grad_accum} must divide --bs "
                         f"{args.batch_size}")
    task = task_settings(args)
    ckpt_dir = job_dir(args, task)
    log = _logger(ckpt_dir)
    log.info("args: %s", vars(args))
    model, cfg = build_model_and_config(args, task)
    dataset = build_datasets(args, task)
    log.info("%d training samples on %s", len(dataset), device)
    init_with_reference_schemes(model, cfg, seed=args.seed)
    if args.checkpoint_path:
        path = args.checkpoint_path
        path = path[:-3] if path.endswith(".pt") else path
        model.load_state_dict(load_checkpoint(path, cfg), strict=True)
        log.info("loaded checkpoint %s", args.checkpoint_path)
    return train(model.to(device), dataset, args, task, device, cfg,
                 ckpt_dir, log)


if __name__ == "__main__":
    main()
