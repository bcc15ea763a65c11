"""3D training of Segtran3d and Segtran25d on a CUDA GPU (BraTS, atria,
MSD).

Counterpart of ``segtran_tpu/cli/train3d.py``: ``--net segtran``
(Segtran3d or ``--segtran 25d``), ``--net vnet`` and ``--net unet`` (the
3-D zoo, ``cli/test3d.build_zoo_model``: PyTorch's default inits drawn
from ``--seed``; ``--attnconsist`` is ignored for them with a warning, as
in JAX; ``--fused`` and ``--fusedepi`` do not reach them). Per
step (``make_step``): per-sample random rot90/flips, the n-hot mask (the
BraTS regions, else one-hot classes), the batch's random zoom
(``--randscale``), optional noise, a resize to ``--inputsize``; then the
forward in training mode, (1 - w) weighted BCE + w class-averaged Dice
(``--diceweight``), with ``--attnconsist`` the weighted
attention-consistency loss, the global-norm clip (``--gradclip``) and
BertAdam with warmup-linear over the reference's parameter groups.
``--fused`` runs the CUDA flash attention forward and backward in the
fusion layers when ``--dropout 0``. Checkpoints ``iter_N.pt`` (BatchNorm
statistics included) with their sidecar every ``--saveiter`` iterations;
``--cp`` resumes from one (a zoo net's sidecar holds ``"config":
null``). Multi-GPU (``parallel/``): launched by ``torchrun
--nproc_per_node N`` with ``--ndevices N`` (-1: the world size), each
process trains its rows of the global batch ``--bs`` with the global
batch's BatchNorm statistics, losses, augmentation draws and averaged
gradients; ``--tp T`` keeps 1/T of the large parameters' master weights
and optimizer moments per rank (compute stays replicated). Rank 0 writes
the logs and checkpoints, which load as any other.

Example (GPU; h5 files need h5py):
  python -m segtran_tpu_torch.cli.train3d --task brats --split all \\
      --maxiter 10000 --translayers 1 --bs 4 --randscale 0.1 \\
      --attractors 1024 --fused --dropout 0 --bf16 --dataroot <h5 root>
  torchrun --standalone --nproc_per_node 2 -m \\
      segtran_tpu_torch.cli.train3d \\
      --ndevices 2 --bs 4 ...        # two GPUs, two rows each
"""
from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Callable

import torch

from .. import resolve_device
from ..data.augment import (noise_draw, resized_crop_3d, resized_crop_draw,
                            rot_flip_3d, rot_flip_draws)
from ..data.labelmaps import index_to_onehot
from ..data.labelmaps3d import brats_map_label
from ..data.pipeline import DevicePrefetcher, batch_iterator
from ..nn.attention import set_dropout_generator
from ..nn.init import init_with_reference_schemes
from ..ops.losses import dice_loss_indiv, weighted_bce_with_logits
from ..ops.norm import global_rows
from ..ops.resize import resize_linear
from ..parallel.mesh import TrainMesh, check_microbatches, resolve_ndevices
from ..parallel.multihost import (from_master, init_multihost, is_master,
                                  master_logging)
from ..train.checkpoint import load_checkpoint, save_checkpoint
from ..train.da import attention_consistency_loss_3d, collect_attn_scores
from ..train.trainer import build_optimizer, make_train_step
from ..utils.meters import AverageMeters
from .test3d import (add_model_args, build_model,
                     build_zoo_model, make_dataset, refuse_later_slices,
                     segtran_config, task_settings)


def build_argparser():
    p = argparse.ArgumentParser(
        description="segtran_tpu_torch 3D training (Segtran3d/25d)")
    add_model_args(p)
    p.add_argument("--split", default="train", choices=["train", "all"])
    p.add_argument("--outdrop", dest="out_fpn_do_dropout",
                   action="store_true")
    p.add_argument("--dropout", dest="dropout_prob", type=float, default=0.1)
    p.add_argument("--attnconsist", dest="use_attn_consist_loss",
                   action="store_true",
                   help="attention-consistency loss: BCE between the "
                        "attention scores and the mask consistency matrix")
    p.add_argument("--attnconsistweight", dest="attn_consist_w", type=float,
                   default=0.01)
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
    p.add_argument("--cp", dest="checkpoint_path", default=None,
                   help="resume from <dir>/iter_N(.pt)")
    p.add_argument("--ckptdir", default="./model")
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--ndevices", type=int, default=-1)
    p.add_argument("--tp", dest="tensor_parallel", type=int, default=1)
    p.add_argument("--fused", dest="use_fused_attention",
                   action="store_true",
                   help="CUDA flash attention forward + backward in the "
                        "fusion layers (with --dropout 0)")
    p.add_argument("--fusedepi", dest="use_fused_epilogue",
                   action="store_true",
                   help="CUDA fused epilogue (eval only; inert in training)")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--norematblocks", dest="remat_blocks",
                   action="store_false", default=True,
                   help="no per-block recompute of the 2.5D EfficientNet "
                        "(no effect on the I3D backbone)")
    p.add_argument("--gradaccum", dest="grad_accum", type=int, default=1)
    return p


def _refuse_later_slices(args) -> None:
    refuse_later_slices(args)


# the JAX CLIs share task_settings; the name stays for train3d's callers
train_task_settings = task_settings


def build_model_and_config(args, task):
    """Segtran3d / Segtran25d in training form: the test3d model flags
    plus dropout, --outdrop, --attnconsist, --remat and the 2.5D
    backbone's per-block recompute (JAX cli/train3d.py:247-294); or a
    3-D zoo net drawn from --seed, and None."""
    _refuse_later_slices(args)
    if args.net != "segtran":
        if args.use_attn_consist_loss:
            logging.getLogger("segtran_tpu_torch.train3d").warning(
                "--attnconsist needs transformer attention scores; "
                "ignored for --net %s", args.net)
            args.use_attn_consist_loss = False
        return build_zoo_model(args, task, seed=args.seed), None
    cfg = segtran_config(
        args, task, hidden_dropout_prob=args.dropout_prob,
        attention_probs_dropout_prob=args.dropout_prob,
        out_fpn_do_dropout=args.out_fpn_do_dropout,
        use_attn_consist_loss=args.use_attn_consist_loss, remat=args.remat,
        remat_blocks=args.remat_blocks)
    return build_model(cfg, task), cfg


def make_attn_consist_loss(args) -> Callable:
    """``aux_loss_fn(model, mask)`` of --attnconsist (JAX
    cli/train3d.py:333-356): the weighted attention-consistency loss of
    the first layer over the model's token grid."""
    if args.remat:
        raise ValueError(
            "no attention scores collected -- remat drops the kept scores; "
            "use --attnconsist without --remat")
    depth_first = args.segtran_type == "3d"      # 25d rasters (h, w, d)
    weight = args.attn_consist_w

    def aux_loss_fn(model, mask):
        scores = collect_attn_scores(model)
        if not scores:
            raise ValueError("no attention scores collected")
        ac = attention_consistency_loss_3d(scores, mask, model.last_grid,
                                           depth_first=depth_first)
        return weight * ac, {"attn_consist_loss": ac.detach()}

    return aux_loss_fn


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
    aux = (make_attn_consist_loss(args) if args.use_attn_consist_loss
           else None)
    base = make_train_step(model, optimizer,
                           make_loss_fn(task, args.max_dice_w, device),
                           grad_accum=max(1, args.grad_accum),
                           grad_clip=args.grad_clip, aux_loss_fn=aux)
    input_size = tuple(task["input_patch_size"])
    host_gen = torch.Generator().manual_seed(args.seed)
    dev_gen = torch.Generator(device=device).manual_seed(args.seed)
    set_dropout_generator(model, dev_gen)

    def draw(image):
        # a data-parallel rank keeps its rows of the global batch's draws
        n = image.shape[0]
        d = {"rot_flip": global_rows(rot_flip_draws, n, host_gen)}
        if args.randscale > 0:
            d["zoom"] = resized_crop_draw(args.randscale, host_gen)
        if args.noise_sigma > 0:
            d["noise"] = global_rows(
                lambda b: noise_draw((b,) + tuple(image.shape[1:]),
                                     args.noise_sigma, generator=dev_gen,
                                     device=image.device), n)
        return d

    def augment(batch, draws=None):
        image, label = batch["image"], batch["label"]
        draws = draw(image) if draws is None else draws
        ks, fhs, fws = draws["rot_flip"]
        pairs = [rot_flip_3d(image[i], label[i], int(ks[i]), bool(fhs[i]),
                             bool(fws[i])) for i in range(image.shape[0])]
        image = torch.stack([p[0] for p in pairs])
        label = torch.stack([p[1] for p in pairs])
        if args.task_name == "brats":
            mask = brats_map_label(label, task["binarize"])
        else:
            mask = index_to_onehot(label, task["num_classes"])
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
    return master_logging(log_dir, "train3d_log.txt",
                          "segtran_tpu_torch.train3d")


def job_dir(args) -> str:
    """As JAX names it, whatever the --net."""
    return os.path.join(args.ckptdir, f"segtran{args.segtran_type}-"
                        f"{args.task_name}-{time.strftime('%m%d%H%M')}")


def train(model, dataset, args, task, device, cfg=None, ckpt_dir=None,
          logger=None):
    """Train ``model`` (already initialised, on ``device``) on any dataset
    of {'image', 'label'} samples for --maxiter steps; returns the
    checkpoint directory. Under a process group each rank loads and trains
    its rows of every global batch (``parallel/mesh.TrainMesh``)."""
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
    par = TrainMesh(model, optimizer, args.ndevices, args.tensor_parallel,
                    grad_accum=args.grad_accum)
    step = par.wrap(make_step(model, par.optimizer, args, task, device))
    meters = AverageMeters()
    iter_num, epoch, t0 = 0, 0, time.time()
    while iter_num < args.maxiter:
        it = batch_iterator(dataset, args.batch_size, epoch, seed=args.seed,
                            keys=("image", "label"), shard=par.shard,
                            microbatches=par.micro)
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
                    sd = par.state_dict()
                    if is_master():
                        save_checkpoint(ckpt_dir, iter_num, sd, cfg)
                    logger.info("saved iter_%d", iter_num)
                if iter_num >= args.maxiter:
                    break
        finally:
            loader.close()
        epoch += 1
    par.finish()
    logger.info("done: %d iters in %.1fs", iter_num, time.time() - t0)
    return ckpt_dir


def main(argv=None):
    """Returns the checkpoint directory."""
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    init_multihost(device, verbose=True)
    check_microbatches(args.batch_size, args.grad_accum,
                       resolve_ndevices(args.ndevices, args.tensor_parallel),
                       args.tensor_parallel)
    _refuse_later_slices(args)
    task = task_settings(args)
    ckpt_dir = from_master(job_dir(args))
    logger = _logger(ckpt_dir)
    logger.info("args: %s", vars(args))
    dataset = make_dataset(args, task, "train", "2019train"
                           if args.task_name == "brats" else "train",
                           crop_size=tuple(task["orig_patch_size"]),
                           seed=args.seed)
    logger.info("%d training volumes on %s", len(dataset), device)
    if task.get("orig_in_channels_probed"):
        logger.info("orig_in_channels probed: %d", task["orig_in_channels"])
    model, cfg = build_model_and_config(args, task)
    if cfg is not None:
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
