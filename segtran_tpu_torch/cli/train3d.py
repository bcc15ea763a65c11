"""3D training of Segtran3d on a CUDA GPU (BraTS).

Counterpart of ``segtran_tpu/cli/train3d.py`` for ``--net segtran
--segtran 3d`` on BraTS. Per step (``make_step``): per-sample random
rot90/flips, the BraTS n-hot mask, the batch's random zoom
(``--randscale``), optional noise, a resize to ``--inputsize``; then the
forward in training mode, (1 - w) weighted BCE + w class-averaged Dice
(``--diceweight``), the global-norm clip (``--gradclip``) and BertAdam with
warmup-linear over the reference's parameter groups. ``--fused`` runs the
CUDA flash attention forward and backward in the squeezed layer when
``--dropout 0``. Checkpoints ``iter_N.pt`` (BatchNorm statistics included)
with their sidecar every ``--saveiter`` iterations; ``--cp`` resumes from
one. Flags whose modules belong to a later slice of the port raise
NotImplementedError.

Example (GPU; BraTS h5 files need h5py):
  python -m segtran_tpu_torch.cli.train3d --task brats --split all \\
      --maxiter 10000 --translayers 1 --bs 4 --randscale 0.1 \\
      --attractors 1024 --fused --dropout 0 --bf16 --dataroot <h5 root>
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
from ..data.augment import (noise_draw, resized_crop_3d, resized_crop_draw,
                            rot_flip_3d, rot_flip_draws)
from ..data.labelmaps3d import brats_map_label
from ..data.pipeline import DevicePrefetcher, batch_iterator
from ..models.segtran3d import Segtran3d
from ..nn.attention import set_dropout_generator
from ..nn.init import init_with_reference_schemes
from ..ops.losses import dice_loss_indiv, weighted_bce_with_logits
from ..ops.resize import resize_linear
from ..train.checkpoint import load_checkpoint, save_checkpoint
from ..train.trainer import build_optimizer, make_train_step
from ..utils.meters import AverageMeters
from .test3d import _ITEM4_3D, segtran3d_config, task_settings


def build_argparser():
    p = argparse.ArgumentParser(
        description="segtran_tpu_torch 3D training (Segtran3d, BraTS)")
    p.add_argument("--task", dest="task_name", default="brats")
    p.add_argument("--ds", dest="ds_name", default=None,
                   help="dataset dir under dataroot/<task>/ (default "
                        "2019train)")
    p.add_argument("--nclasses", dest="num_classes", type=int, default=-1)
    p.add_argument("--mod", dest="chosen_modality", type=int, default=-1)
    p.add_argument("--xyzpermute", dest="xyz_permute", default=None)
    p.add_argument("--split", default="train", choices=["train", "all"])
    p.add_argument("--dataroot", default="../data")
    p.add_argument("--net", default="segtran")
    p.add_argument("--segtran", dest="segtran_type", default="3d")
    p.add_argument("--bb", dest="backbone_type", default=None)
    p.add_argument("--into3", dest="inchan_to3_scheme", default=None)
    p.add_argument("--pos", dest="pos_code_type", default="lsinu")
    p.add_argument("--nosqueeze", dest="use_squeezed_transformer",
                   action="store_false")
    p.add_argument("--multihead", dest="ablate_multihead",
                   action="store_true")
    p.add_argument("--infpn", dest="in_fpn_layers", default="34")
    p.add_argument("--outfpn", dest="out_fpn_layers", default="1234")
    p.add_argument("--attnclip", dest="attn_clip", type=float, default=500.0)
    p.add_argument("--posw", dest="pos_code_weight", type=float, default=1.0)
    p.add_argument("--squeezeuseffn", dest="has_FFN_in_squeeze",
                   action="store_true")
    p.add_argument("--outdrop", dest="out_fpn_do_dropout",
                   action="store_true")
    p.add_argument("--nofeatup", dest="bb_feat_upsize", action="store_false")
    p.add_argument("--translayers", dest="num_translayers", type=int,
                   default=1)
    p.add_argument("--layercompress", dest="translayer_compress_ratios",
                   default=None)
    p.add_argument("--attractors", dest="num_attractors", type=int,
                   default=1024)
    p.add_argument("--modes", dest="num_modes", type=int, default=4)
    p.add_argument("--dropout", dest="dropout_prob", type=float, default=0.1)
    p.add_argument("--noqkbias", dest="qk_have_bias", action="store_false")
    p.add_argument("--attnconsist", dest="use_attn_consist_loss",
                   action="store_true")
    p.add_argument("--upd", dest="out_fpn_upsampleD_scheme", default=None,
                   choices=[None, "interp", "conv", "none"])
    p.add_argument("--dgroup", dest="d_groupsize", type=int, default=-1)
    p.add_argument("--dpool", dest="d_pool_k", type=int, default=-1)
    p.add_argument("--maxiter", type=int, default=10000)
    p.add_argument("--saveiter", type=int, default=500)
    p.add_argument("--bs", dest="batch_size", type=int, default=4)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--decay", type=float, default=1e-4)
    p.add_argument("--gradclip", dest="grad_clip", type=float, default=0.1)
    p.add_argument("--lrwarmup", dest="lr_warmup_steps", type=int,
                   default=500)
    p.add_argument("--diceweight", dest="max_dice_w", type=float, default=0.5)
    p.add_argument("--randscale", type=float, default=0.1)
    p.add_argument("--noise", dest="noise_sigma", type=float, default=0.0)
    p.add_argument("--patchsize", dest="orig_patch_size", default=None,
                   help="crop size, e.g. 112,112,96")
    p.add_argument("--inputsize", dest="input_patch_size", default=None)
    p.add_argument("--scale", dest="input_scale", default=None,
                   help="per-axis input/crop scale, e.g. 0.5,0.5,1")
    p.add_argument("--cp", dest="checkpoint_path", default=None,
                   help="resume from <dir>/iter_N(.pt)")
    p.add_argument("--ckptdir", default="./model")
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--ndevices", type=int, default=-1)
    p.add_argument("--tp", dest="tensor_parallel", type=int, default=1)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--fused", dest="use_fused_attention",
                   action="store_true",
                   help="CUDA flash attention forward + backward in the "
                        "squeezed layer (with --dropout 0)")
    p.add_argument("--fusedepi", dest="use_fused_epilogue",
                   action="store_true",
                   help="CUDA fused epilogue (eval only; inert in training)")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--norematblocks", dest="remat_blocks",
                   action="store_false", default=True,
                   help="no effect on the 3D I3D backbone")
    p.add_argument("--gradaccum", dest="grad_accum", type=int, default=1)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; no GPU and no --device cpu "
                        "is an error")
    return p


def _refuse_later_slices(args) -> None:
    later = [
        (args.task_name != "brats", f"--task {args.task_name}",
         "the atria/MSD datasets"),
        (args.net != "segtran", f"--net {args.net}", "the 3D model zoo"),
        (args.segtran_type != "3d", f"--segtran {args.segtran_type}",
         "the 2.5D/mince slice"),
        (args.d_groupsize > 0, "--dgroup", "the 2.5D/mince slice"),
        (args.chosen_modality != -1, "--mod", "the atria/MSD datasets"),
        (args.xyz_permute is not None, "--xyzpermute",
         "the atria/MSD datasets"),
        (args.backbone_type not in (None, "i3d"), f"--bb {args.backbone_type}",
         "the 3D backbones of the model zoo"),
        (args.inchan_to3_scheme not in (None, "bridgeconv"),
         f"--into3 {args.inchan_to3_scheme}", "the 3D input bridges"),
        (args.use_attn_consist_loss, "--attnconsist", "the DA slice"),
        (args.tensor_parallel > 1 or args.ndevices > 1,
         "--tp/--ndevices above 1", "the multi-GPU slice"),
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


def train_task_settings(args):
    """TASK_SETTINGS['brats'] with the crop/input sizes and --nclasses."""
    task = task_settings(args)
    if args.input_scale and not args.input_patch_size:
        sc = [float(v) for v in str(args.input_scale).split(",")]
        task["input_patch_size"] = tuple(
            int(s * n) for s, n in zip(sc, task["orig_patch_size"]))
    if args.num_classes > 0:
        task["num_classes"] = args.num_classes
        task["bce_weight"] = (0.0,) + (1.0,) * (args.num_classes - 1)
        task["binarize"] = args.num_classes == 2
    return task


def build_model_and_config(args, task):
    """Segtran3d in training form: the test3d model flags plus dropout,
    --outdrop and --remat (reference train3d.py:247-294)."""
    _refuse_later_slices(args)
    kw = {}
    if args.backbone_type:
        kw["backbone_type"] = args.backbone_type
    if args.inchan_to3_scheme:
        kw["inchan_to3_scheme"] = args.inchan_to3_scheme
    cfg = segtran3d_config(
        args, task, hidden_dropout_prob=args.dropout_prob,
        attention_probs_dropout_prob=args.dropout_prob,
        out_fpn_do_dropout=args.out_fpn_do_dropout, remat=args.remat, **kw)
    return Segtran3d(cfg), cfg


def make_loss_fn(task, dice_w: float, device):
    """(logits, mask [B, H, W, D, C]) -> (loss, metrics): (1 - dice_w) BCE
    with the task's pos weights + dice_w Dice averaged over classes 1..C-1
    (reference train3d.py:315-328)."""
    n = task["num_classes"]
    pos_weight = None
    if not task["binarize"]:
        w = torch.tensor(task["bce_weight"], dtype=torch.float32)
        pos_weight = (w * (n - 1) / w.sum()).reshape(1, 1, 1, 1, n).to(device)
    class_w = torch.ones(n)
    class_w[0] = 0.0
    class_w = (class_w / class_w.sum()).to(device)

    def loss_fn(logits, mask):
        if logits.shape[1:4] != mask.shape[1:4]:
            logits = resize_linear(logits, mask.shape[1:4])
        probs = torch.sigmoid(logits)
        ce = weighted_bce_with_logits(logits, mask, pos_weight)
        dice_total = 0.0
        metrics = {}
        for cls in range(1, n):
            d = dice_loss_indiv(probs[..., cls], mask[..., cls])
            metrics[f"dice_loss_cls{cls}"] = d.detach()
            dice_total = dice_total + d * class_w[cls]
        loss = (1 - dice_w) * ce + dice_w * dice_total
        metrics.update(loss=loss.detach(), ce_loss=ce.detach(),
                       dice_loss=dice_total.detach())
        return loss, metrics

    return loss_fn


def make_step(model, optimizer, args, task, device):
    """step(batch {'image' [B, H, W, D, C], 'label' [B, H, W, D]} on the
    device, draws=None) -> metrics. The augmentation draws come from
    generators seeded with --seed unless ``draws`` gives them:
    {'rot_flip': (k, flip_h, flip_w) per sample, 'zoom': f, 'noise':
    tensor} (reference train3d.py:361-379)."""
    base = make_train_step(model, optimizer,
                           make_loss_fn(task, args.max_dice_w, device),
                           grad_accum=max(1, args.grad_accum),
                           grad_clip=args.grad_clip)
    input_size = tuple(task["input_patch_size"])
    host_gen = torch.Generator().manual_seed(args.seed)
    dev_gen = torch.Generator(device=device).manual_seed(args.seed)
    set_dropout_generator(model, dev_gen)

    def draw(image):
        d = {"rot_flip": rot_flip_draws(image.shape[0], host_gen)}
        if args.randscale > 0:
            d["zoom"] = resized_crop_draw(args.randscale, host_gen)
        if args.noise_sigma > 0:
            d["noise"] = noise_draw(image.shape, args.noise_sigma,
                                    generator=dev_gen, device=image.device)
        return d

    def augment(batch, draws=None):
        image, label = batch["image"], batch["label"]
        draws = draw(image) if draws is None else draws
        ks, fhs, fws = draws["rot_flip"]
        pairs = [rot_flip_3d(image[i], label[i], int(ks[i]), bool(fhs[i]),
                             bool(fws[i])) for i in range(image.shape[0])]
        image = torch.stack([p[0] for p in pairs])
        mask = brats_map_label(torch.stack([p[1] for p in pairs]),
                               task["binarize"])
        if args.randscale > 0:
            image, mask = resized_crop_3d(image, mask, draws["zoom"])
        if args.noise_sigma > 0:
            image = image + draws["noise"]
        if tuple(image.shape[1:4]) != input_size:
            image = resize_linear(image, input_size)
        return {"image": image, "mask": mask}

    def step(batch, draws=None):
        return base(augment(batch, draws))

    step.augment = augment
    return step


def _logger(log_dir):
    os.makedirs(log_dir, exist_ok=True)
    logger = logging.getLogger("segtran_tpu_torch.train3d")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("[%(asctime)s] %(message)s", "%H:%M:%S")
    for h in (logging.FileHandler(os.path.join(log_dir, "train3d_log.txt")),
              logging.StreamHandler(sys.stdout)):
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


def job_dir(args) -> str:
    return os.path.join(args.ckptdir, f"segtran{args.segtran_type}-"
                        f"{args.task_name}-{time.strftime('%m%d%H%M')}")


def train(model, dataset, args, task, device, cfg=None, ckpt_dir=None,
          logger=None):
    """Train ``model`` (already initialised, on ``device``) on any dataset
    of {'image', 'label'} samples for --maxiter steps; returns the
    checkpoint directory."""
    ckpt_dir = ckpt_dir or job_dir(args)
    logger = logger or _logger(ckpt_dir)
    if args.grad_accum > 1 and args.batch_size % args.grad_accum:
        raise ValueError(f"--gradaccum {args.grad_accum} must divide --bs "
                         f"{args.batch_size}")
    if args.use_fused_attention and args.dropout_prob > 0:
        logger.warning("--fused is inert during training with attention "
                       "dropout %.2f; pass --dropout 0 to engage the flash "
                       "kernels", args.dropout_prob)
    warmup_ratio = min(args.lr_warmup_steps, args.maxiter // 2) / args.maxiter
    optimizer = build_optimizer(model, lr=args.lr, decay=args.decay,
                                t_total=args.maxiter,
                                warmup_ratio=warmup_ratio)
    step = make_step(model, optimizer, args, task, device)
    meters = AverageMeters()
    iter_num, epoch, t0 = 0, 0, time.time()
    while iter_num < args.maxiter:
        it = batch_iterator(dataset, args.batch_size, epoch, seed=args.seed,
                            keys=("image", "label"))
        loader = DevicePrefetcher(it, device)
        try:
            for batch in loader:
                metrics = step(batch)
                iter_num += 1
                values = torch.stack(list(metrics.values())).tolist()
                for k, v in zip(metrics, values):
                    meters.update(k, v)
                if iter_num == 1:
                    logger.info("first step done in %.1fs", time.time() - t0)
                if iter_num % 50 == 0:
                    logger.info("iter %d (%.2f it/s): %s", iter_num,
                                iter_num / (time.time() - t0),
                                meters.disp_str(("loss", "ce_loss",
                                                 "dice_loss")))
                    meters.reset_disp()
                if iter_num % args.saveiter == 0 or iter_num >= args.maxiter:
                    save_checkpoint(ckpt_dir, iter_num, model.state_dict(),
                                    cfg)
                    logger.info("saved iter_%d", iter_num)
                if iter_num >= args.maxiter:
                    break
        finally:
            loader.close()
        epoch += 1
    logger.info("done: %d iters in %.1fs", iter_num, time.time() - t0)
    return ckpt_dir


def main(argv=None):
    """Returns the checkpoint directory."""
    from ..data.datasets3d import BratsSet
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    _refuse_later_slices(args)
    task = train_task_settings(args)
    model, cfg = build_model_and_config(args, task)
    ckpt_dir = job_dir(args)
    logger = _logger(ckpt_dir)
    logger.info("args: %s", vars(args))
    dataset = BratsSet(
        os.path.join(args.dataroot, args.task_name,
                     args.ds_name or "2019train"),
        split=args.split, mode="train",
        crop_size=tuple(task["orig_patch_size"]),
        binarize=task["binarize"], seed=args.seed)
    logger.info("%d training volumes on %s", len(dataset), device)
    init_with_reference_schemes(model, cfg, seed=args.seed)
    if args.checkpoint_path:
        path = args.checkpoint_path
        path = path[:-3] if path.endswith(".pt") else path
        model.load_state_dict(load_checkpoint(path, cfg), strict=True)
        logger.info("loaded checkpoint %s", args.checkpoint_path)
    return train(model.to(device), dataset, args, task, device, cfg,
                 ckpt_dir, logger)


if __name__ == "__main__":
    main()
