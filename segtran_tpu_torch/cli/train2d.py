"""2-D training of Segtran2d, the Polyformer's U-Net and the baseline zoo
on a CUDA GPU (REFUGE fundus, polyp, OCT), supervised or with domain
adaptation.

Counterpart of ``segtran_tpu/cli/train2d.py``: ``--net segtran`` (``--bb``
eff-*, effv2s/m/l or resnet34/50/101), ``unet-scratch`` and the zoo
(``build_zoo_model``: unet / unet-smp on a ResNet or EfficientNet
encoder, nestedunet, unet3plus, attunet, r2attunet, dunet, transunet,
setr, deeplabv3, deeplabv3plus / deeplab-smp, pranet, nnunet), with
``--opt bertadam|adamw|sgd|adam`` and ``--optfilter``. Per step
(``make_step``) on the device: the task's label map of the raw masks,
the batched 2-D augmentation
(``data/augment.py``: crop-and-pad ``--randscale``, flips, quarter
turns, ``--affine``, the gray blend ``--gray``, the colour jitter,
``--robustaug``, normalisation by the dataset's mean/std table, per
sample in a multi-``--ds`` run), a
bilinear resize to the patch size; then the forward in training mode,
(1 - w) weighted BCE + w class-weighted Dice (``--diceweight``,
``--focus``), the global-norm clip and BertAdam with warmup-linear over
the reference's parameter groups, with ``--gradaccum`` microbatches.
``--fused`` runs the CUDA flash attention in the squeezed layers when
``--dropout 0``. The model options of the paper's ablations build as JAX
builds them: ``--nosqueeze``, ``--pos rand|sinu|bias`` (``--posr``,
``--posw``), ``--multihead``, ``--inbn``, ``--gbias``, and ``--outfpn``
equal to ``--infpn`` (no output FPN), ``--nosqueeze --mince``.

Domain adaptation and the auxiliary losses (JAX ``make_full_step``,
reference train2d.py:1228-1318), each held to JAX on the CPU:
``--polyformer source|target`` (the U-Net's adapter; ``--sourceopt`` /
``--targetopt`` choose the trained parameters, BertAdam without weight
decay or global clip), ``--tunebn`` (no updates; the running statistics
move), ``--adv feat|mask`` (a gradient-reversal discriminator on the
features or predicted masks of a target batch and a ``--sourceds`` batch
of ``--sourcebs``; ``--adda`` trains it on detached features and the net
against its detached parameters), ``--reconweight``, ``--vcdr
single|sep`` (learned vCDR estimators), ``--contrastweight`` with
``--reffeatcp`` (``--negcontrast``), ``--attnconsist`` and ``--attndiag``.
The net's running statistics move with the target batch only, the
discriminator's and the estimators' once per step from their last call,
as JAX keeps them. Checkpoints ``iter_N.pt`` with their sidecar every
``--saveiter`` iterations and at the end (a DA run's under ``net.``,
``discriminator.``, ...); ``--cp`` starts from one, parameters it lacks
keeping their fresh values as JAX's ``merge_params`` keeps them.
``--profile`` logs the parameters and one eval forward's FLOPs, bytes
and images per second at a batch of one patch before training (JAX's
--profile; no trace). Multi-GPU (``parallel/``): launched by ``torchrun
--nproc_per_node N`` with ``--ndevices N`` (-1: the world size), each
process trains its rows of the global batch ``--bs`` with the global
batch's BatchNorm statistics, batch-joint losses (``--attnconsist``, the
contrast losses), augmentation draws and averaged gradients; ``--tp T``
keeps 1/T of the large parameters' master weights and optimizer moments
per rank, ``--ep`` those of the per-mode private weights by whole modes
(compute stays replicated). Rank 0 writes the logs, TensorBoard and the
checkpoints, which hold the full state_dict.

Example (GPU; reading the PNG frames needs Pillow):
  python -m segtran_tpu_torch.cli.train2d --task fundus --translayers 3 \\
      --layercompress 1,1,2,2 --net segtran --bb eff-b4 --maxiter 10000 \\
      --bs 6 --noqkbias --bf16 --dataroot <dataroot>
  torchrun --standalone --nproc_per_node 2 -m \\
      segtran_tpu_torch.cli.train2d \\
      --ndevices 2 --bs 6 ...        # two GPUs, three rows each
"""
from __future__ import annotations

import argparse
import contextlib
import logging
import os
import time

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..adapt.polyformer import polyformer_param_labels
from ..configs.base import Segtran2dConfig
from ..configs.presets import NET_SETTINGS, TASK_SETTINGS
from ..data.augment import Aug2dConfig, augment_batch_2d, draw_2d
from ..data.labelmaps import fundus_map_mask, index_to_onehot, polyp_map_mask
from ..data.pipeline import DevicePrefetcher, batch_iterator
from ..data.stats import load_dataset_stats
from ..models.att_unet import AttUNet
from ..models.deeplab import DeepLabV3, DeepLabV3Plus
from ..models.discriminator import Discriminator
from ..models.dunet import DUNetV1V2
from ..models.generic_unet import GenericUNet
from ..models.nested_unet import NestedUNet
from ..models.pranet import PraNetForTraining
from ..models.segtran2d import Segtran2d
from ..models.setr import SETR_PUP
from ..models.transunet import TransUNet
from ..models.unet2d import VanillaUNet
from ..models.unet_3plus import UNet3Plus
from ..models.unet_smp import UnetSMP
from ..nn.attention import set_dropout_generator
from ..nn.features import drop_kept_features
from ..nn.init import init_with_reference_schemes
from ..ops.norm import (average_gradients, frozen_running_stats,
                        global_rows)
from ..ops.resize import resize_linear
from ..parallel.mesh import TrainMesh, check_microbatches, resolve_ndevices
from ..parallel.multihost import (from_master, init_multihost, is_master,
                                  master_logging)
from ..train.bertadam import BertAdam
from ..train.checkpoint import (load_checkpoint, net_state_dict,
                                save_checkpoint)
from ..train.contrast import calc_contrast_losses, load_reference_features
from ..train.da import (attention_consistency_loss, collect_attn_diag,
                        collect_attn_scores, domain_adversarial_loss,
                        recon_loss, vcdr_estimation_losses)
from ..train.trainer import (build_optimizer, clip_by_global_norm_,
                             global_metrics, make_loss_fn, make_train_step,
                             resolve_remat_blocks)
from ..utils.meters import AverageMeters
from ..tools.flops import count_params, estimate_flops, measure_fps

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
    p.add_argument("--optfilter", dest="opt_filters", default=None,
                   help="comma-separated substrings: only parameters whose "
                        "name holds one train. Names are the port's dotted "
                        "state_dict names (backbone.layer4.0.conv1.weight); "
                        "JAX matches its '/'-joined paths "
                        "(backbone/layer4_0/conv1/kernel), so a filter that "
                        "spells a separator or a leaf name differs")
    p.add_argument("--opt", dest="opt_name", default="bertadam",
                   choices=["bertadam", "adamw", "sgd", "adam"],
                   help="optimizer (adamw == bertadam); sgd: momentum "
                        "0.9, decay 1e-4; adam: decay 1e-4; neither clips")
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


ZOO = ("unet", "unet-smp", "nestedunet", "unet3plus", "attunet",
       "r2attunet", "dunet", "transunet", "setr", "deeplabv3",
       "deeplabv3plus", "deeplab-smp", "pranet", "nnunet")
NETS = ("segtran", "unet-scratch") + ZOO
VCDR_NAMES = {"single": ("vcdr_estim",), "sep": ("vc_estim", "vd_estim")}


def _refuse_later_slices(args) -> None:
    if args.net not in NETS:
        raise ValueError(f"unknown --net {args.net}")
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
    """The --net in training form (JAX train2d.py:295-405): Segtran2d and
    its config, or the U-Net (with ``--polyformer``) or a zoo net and
    None. An unset --rematblocks/--norematblocks takes
    ``resolve_remat_blocks``."""
    _refuse_later_slices(args)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    if args.net in ZOO:
        # the zoo nets start from PyTorch's default inits (nn/init.py's
        # torch_conv_kernel_init), drawn from --seed
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(args.seed)
            return build_zoo_model(args, task, dtype), None
    if args.net == "unet-scratch":
        return VanillaUNet(
            3, task["num_classes"], polyformer_mode=args.polyformer_mode,
            num_attractors=args.num_attractors,
            num_modes=4 if args.num_modes == -1 else args.num_modes,
            bn_eval=args.bn_opt_scheme == "fixstats", dtype=dtype), None
    if args.polyformer_mode:
        logger.info("--polyformer adds no Polyformer to --net segtran (as "
                    "in JAX); --sourceopt/--targetopt still choose the "
                    "trained parameters")
    if args.remat_blocks is None:
        args.remat_blocks, mb = resolve_remat_blocks(
            args.batch_size, args.grad_accum,
            resolve_ndevices(args.ndevices, args.tensor_parallel),
            args.tensor_parallel)
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
        use_attn_consist_loss=args.use_attn_consist_loss,
        attn_diag=args.attn_diag_cycles > 0,
        use_fused_attention=args.use_fused_attention,
        use_fused_epilogue=args.use_fused_epilogue,
        remat=args.remat,
        remat_blocks=bool(args.remat_blocks),
        pos_code_type=args.pos_code_type,
        use_mince_transformer=args.use_mince_transformer,
        mince_scales=(tuple(int(v) for v in args.mince_scales.split(","))
                      if args.mince_scales else None),
        mince_channel_props=(
            tuple(float(v) for v in args.mince_channel_props.split(","))
            if args.mince_channel_props else None),
        in_fpn_layers=tuple(int(c) for c in args.in_fpn_layers),
        out_fpn_layers=tuple(int(c) for c in args.out_fpn_layers),
        hidden_dropout_prob=dropout,
        attention_probs_dropout_prob=dropout,
        dtype=dtype,
    ).derive(translayer_compress_ratios=compress)
    if args.use_fused_attention and dropout > 0:
        logger.warning("--fused is inert during training with attention "
                       "dropout %.2f; pass --dropout 0 to engage the flash "
                       "kernels", dropout)
    return Segtran2d(cfg, patch_size=task["patch_size"]), cfg


def build_zoo_model(args, task, dtype):
    """The baseline zoo (JAX train2d.py:366-405, reference --net dispatch
    train2d.py:933-1032). The resnet-hybrid nets keep a resnet --bb, else
    take resnet50 and say so; TransUNet and SETR fix their position
    tables at --patchsize."""
    net, nc, bb = args.net, task["num_classes"], args.backbone_type

    def resnet_bb():
        if bb.startswith("resnet"):
            return bb
        logger.info("--net %s needs a resnet backbone; ignoring --bb %s and "
                    "using resnet50", net, bb)
        return "resnet50"

    patch = tuple(task["patch_size"])
    if net in ("unet", "unet-smp"):
        return UnetSMP(nc, encoder=bb, dtype=dtype)
    if net == "nestedunet":
        return NestedUNet(nc, dtype=dtype)
    if net == "unet3plus":
        return UNet3Plus(nc, dtype=dtype)
    if net in ("attunet", "r2attunet"):
        return AttUNet(nc, recurrent=net == "r2attunet", dtype=dtype)
    if net == "dunet":
        return DUNetV1V2(n_classes=nc, dtype=dtype)
    if net == "transunet":
        resnet_bb()            # the hybrid stem is fixed; JAX says so too
        if patch[0] != patch[1]:
            raise ValueError(f"--net transunet takes a square --patchsize, "
                             f"not {patch}")
        return TransUNet(nc, img_size=patch[0], dtype=dtype)
    if net == "setr":
        return SETR_PUP(nc, img_size=patch, dtype=dtype)
    if net == "deeplabv3":
        return DeepLabV3(nc, backbone=resnet_bb(), dtype=dtype)
    if net in ("deeplabv3plus", "deeplab-smp"):
        return DeepLabV3Plus(nc, backbone=resnet_bb(), dtype=dtype)
    if net == "pranet":
        return PraNetForTraining(nc, dtype=dtype)
    return GenericUNet(nc, deep_supervision=False, dtype=dtype)


def optimizer_settings(args):
    """(lr, decay, grad_clip): the flags where set, else --net's preset."""
    net_set = NET_SETTINGS.get(args.net, NET_SETTINGS["unet-like"])
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


def uses_vcdr(args) -> bool:
    return args.task_name == "fundus" and args.vcdr_estim_scheme != "none"


class ReconHead(nn.Module):
    """The 1x1 conv from the DA feature to the 3 image channels (JAX
    train2d.py:552-559; reference train2d.py:923-926), in fp32."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, 3, 1)

    def forward(self, x):
        w = self.conv.weight[:, :, 0, 0]
        return torch.matmul(x.float(), w.t()) + self.conv.bias


def build_aux_modules(args, task, cfg) -> nn.ModuleDict:
    """The modules trained beside the net (JAX train2d.py:512-587), each
    initialised from its own seed: the discriminator (--adv; no gradient
    reversal under --adda) on the DA feature's channels, the recon head
    (--reconweight), the vCDR estimators (--vcdr on fundus: the
    discriminator CNN on the predicted probabilities)."""
    aux = nn.ModuleDict()
    if args.adversarial_mode == "mask" or args.net in ZOO:
        # a zoo net keeps no feature: --adv feat and --reconweight fail on
        # it at the first step, as in JAX
        ch = task["num_classes"]
    else:
        ch = 64 if args.net == "unet-scratch" else cfg.trans_out_dim
    if args.adversarial_mode:
        aux["discriminator"] = init_with_reference_schemes(
            Discriminator(ch, num_classes=1, do_revgrad=not args.adda),
            seed=args.seed + 7)
    if args.recon_w > 0:
        aux["recon"] = init_with_reference_schemes(ReconHead(ch),
                                                   seed=args.seed + 8)
    if uses_vcdr(args):
        for i, name in enumerate(VCDR_NAMES[args.vcdr_estim_scheme]):
            aux[name] = init_with_reference_schemes(
                Discriminator(task["num_classes"], num_classes=1,
                              do_revgrad=False), seed=args.seed + 9 + i)
    return aux


def build_train_optimizer(wrapped, net, args):
    """The optimizer of JAX train2d (:454-510) over ``wrapped`` (the net,
    or a DA run's net + aux modules), and the global clip before it.
    --tunebn: none (every parameter frozen). --polyformer: one BertAdam
    group without weight decay over the parameters
    ``polyformer_param_labels`` selects (their own 0.05 clip, no global
    one), the rest frozen; under DA the labels see the wrapped names, as
    JAX's do. Otherwise BertAdam over the reference's groups with the
    global clip. Frozen parameters take no gradient."""
    lr, decay, clip = optimizer_settings(args)
    warmup_ratio = min(args.lr_warmup_steps, args.maxiter // 2) / args.maxiter
    if args.tune_bn_only:
        wrapped.requires_grad_(False)
        return None, 0.0
    if args.polyformer_mode:
        opt_mode = (args.poly_source_opt if args.polyformer_mode == "source"
                    else args.poly_target_opt)
        bn = {n.rsplit(".", 1)[0] for n, _ in net.named_buffers()
              if n.endswith("running_mean")}
        labels = polyformer_param_labels(
            [n for n, _ in wrapped.named_parameters()], opt_mode, bn,
            args.bn_opt_scheme)
        trained = []
        for n, p in wrapped.named_parameters():
            p.requires_grad_(labels[n])
            if labels[n]:
                trained.append(p)
        if not trained:
            return None, 0.0
        return BertAdam([dict(params=trained, lr=lr, weight_decay=0.0)],
                        lr=lr, warmup=warmup_ratio,
                        t_total=args.maxiter), 0.0
    if args.opt_filters:
        # --optfilter: the other parameters freeze; the clip sees the
        # trained ones only, as JAX's masked chain does
        filters = [f for f in str(args.opt_filters).split(",") if f]
        for n, p in wrapped.named_parameters():
            p.requires_grad_(any(f in n for f in filters))
    params = [p for p in wrapped.parameters() if p.requires_grad]
    if args.opt_name == "sgd":
        # JAX: add_decayed_weights(1e-4), then sgd(momentum 0.9); no clip
        return torch.optim.SGD(params, lr=lr, momentum=0.9,
                               weight_decay=1e-4), 0.0
    if args.opt_name == "adam":
        # JAX: add_decayed_weights(1e-4), scale_by_adam, scale(-lr)
        return torch.optim.Adam(params, lr=lr, weight_decay=1e-4), 0.0
    return build_optimizer(wrapped, lr=lr, decay=decay,
                           t_total=args.maxiter,
                           warmup_ratio=warmup_ratio), clip


def load_contrast_bank(args, task, device):
    """(bank [K, R, C], valid [K, R], class weights [K]) on ``device`` from
    --reffeatcp (JAX train2d.py:592-606): the BCE's pos-weights rescaled to
    sum to K - 1."""
    sel = (tuple(int(v) for v in args.selected_ref_classes.split(","))
           if args.selected_ref_classes else None)
    bank, valid = load_reference_features(
        args.ref_feat_cp_path, args.num_ref_features, task["num_classes"],
        sel, seed=args.seed)
    bw = np.asarray(task["bce_weight"], np.float32)
    bw = bw * (task["num_classes"] - 1) / bw.sum()
    return tuple(torch.as_tensor(a, device=device) for a in (bank, valid, bw))


def _da_feature(model):
    """JAX train2d's ``_da_feature`` (:444-462): the U-Net's features
    before ``outc``; Segtran2d's last translayer tokens on the token grid,
    or the input FPN's output where it keeps none (--remat, --gbias)."""
    for name in ("pre_outc_feat", "last_layer_feat", "in_fpn_feat"):
        feat = getattr(model, name, None)
        if feat is not None:
            return feat
    raise ValueError("the model kept no DA feature (keep_features off)")


def _diag_metrics(model):
    """attn_max / attn_avg / attn_clamped of --attndiag (none after a
    flash forward, which keeps no diagnostics, as in JAX)."""
    diag = collect_attn_diag(model)
    if diag is None:
        return {}
    return {"attn_max": diag[0], "attn_avg": diag[1],
            "attn_clamped": diag[2]}


def make_step(model, optimizer, args, task, device, ds_stats=None,
              aux=None, grad_clip=None, contrast_bank=None):
    """step(batch {'image' [B, H, W, 3] float in [0, 1], 'mask' [B, H, W,
    C] raw uint8, with ``ds_stats`` 'ds_idx' [B], with a discriminator
    'source_image' [B_s, H, W, 3]} on the device, draws=None) -> metrics.
    The augmentation draws come from a generator on the device seeded with
    --seed (which the model's dropout shares) unless ``draws``
    (``data/augment.draw_2d``) gives them. ``ds_stats``: (mean [D, C], std
    [D, C]) of a multi-dataset run, indexed per sample by 'ds_idx'
    (reference train_util.py:100-106). ``aux``: a DA run's modules
    (``build_aux_modules``); ``grad_clip``: the global clip (default the
    --net's); ``contrast_bank``: ``load_contrast_bank``'s. With any of
    them or --attnconsist the step is JAX ``make_full_step``'s with its
    auxiliary losses (``_full_step``), else the supervised one."""
    mean, std = load_stats(args, dataset_names(args, task)[0])
    cfg = aug_config(args, mean, std)
    patch = tuple(task["patch_size"])
    loss_fn = make_loss_fn(task["num_classes"], task["bce_weight"],
                           dice_w=args.max_dice_w,
                           focus_class=args.focus_class)
    grad_clip = optimizer_settings(args)[2] if grad_clip is None \
        else grad_clip
    gen = torch.Generator(device=device).manual_seed(args.seed)
    set_dropout_generator(model, gen)
    if ds_stats is not None:
        ds_stats = tuple(torch.as_tensor(np.asarray(t, np.float32),
                                         device=device) for t in ds_stats)

    def augment(batch, draws=None):
        image = batch["image"]
        mask = map_mask(args, task, batch["mask"])
        if draws is None:
            # a data-parallel rank keeps its rows of the global draws
            draws = global_rows(draw_2d, image.shape[0], cfg, gen)
        mu = sd = None
        if ds_stats is not None and "ds_idx" in batch:
            idx = batch["ds_idx"].long()
            mu, sd = ds_stats[0][idx], ds_stats[1][idx]
        image, mask = augment_batch_2d(image, mask, draws, cfg, mu, sd)
        return {"image": resize_linear(image, patch), "mask": mask}

    aux = nn.ModuleDict() if aux is None else aux
    if len(aux) or contrast_bank is not None or args.use_attn_consist_loss:
        if args.grad_accum > 1:
            # the source batch and the bank are whole-batch structures and
            # the consistency loss is batch-joint (one count, the cap)
            raise ValueError("--gradaccum > 1 is supported for the "
                             "supervised path only (no DA/recon/vCDR/"
                             "contrast/attnconsist)")
        src_stats = (load_stats(args, args.source_ds_name)
                     if "discriminator" in aux else None)
        step = _full_step(model, aux, optimizer, loss_fn, args, task,
                          augment, gen, cfg, patch, src_stats, contrast_bank,
                          grad_clip)
    else:
        if args.supervised_w != 1.0:
            unscaled = loss_fn

            def loss_fn(logits, mask):
                loss, metrics = unscaled(logits, mask)
                loss = args.supervised_w * loss
                return loss, dict(metrics, loss=loss)
        diag = ((lambda m, mask: (0.0, _diag_metrics(m)))
                if args.attn_diag_cycles > 0 else None)
        base = make_train_step(model, optimizer, loss_fn,
                               grad_accum=max(1, args.grad_accum),
                               grad_clip=grad_clip, aux_loss_fn=diag)

        def step(batch, draws=None):
            return base(augment(batch, draws))

    step.augment = augment
    return step


def _full_step(model, aux, optimizer, loss_fn, args, task, augment, gen,
               aug_cfg, patch, src_stats, contrast_bank, grad_clip):
    """JAX ``make_full_step`` with its auxiliary losses (cli/train2d.py
    :465-770 of the JAX package), in its order: the segmentation loss, the
    attention diagnostics, --attnconsist, the contrast losses, the
    --supweight scale, recon, the discriminator on a source pass (whose
    running-statistics updates are dropped), the vCDR estimators; one
    backward, the global clip, one update. step(batch, draws=None,
    src_draws=None, neg_offsets=None): the latter two stand in for the
    source batch's augmentation draws and --negcontrast's class offsets
    [K] in [1, K)."""
    disc = aux["discriminator"] if "discriminator" in aux else None
    recon = aux["recon"] if "recon" in aux else None
    vcdr = [aux[n] for n in VCDR_NAMES.get(args.vcdr_estim_scheme, ())
            if n in aux]
    feat_mode = args.adversarial_mode == "feat"
    keep = ((disc is not None and feat_mode) or recon is not None
            or contrast_bank is not None)
    params = list(model.parameters()) + list(aux.parameters())
    sup_w = args.supervised_w
    count = [0]

    def frozen_disc_call(v):
        # the generator's ADDA loss: the discriminator's parameters
        # detached, its running statistics its own
        return torch.func.functional_call(
            disc, {n: p.detach() for n, p in disc.named_parameters()}, (v,))

    def step(batch, draws=None, src_draws=None, neg_offsets=None):
        aug = augment(batch, draws)
        image, mask = aug["image"], aug["mask"]
        model.train()
        aux.train()
        model.zero_grad(set_to_none=True)
        aux.zero_grad(set_to_none=True)
        model.keep_features = keep
        try:
            logits = model(image)
            loss, metrics = loss_fn(logits, mask)
            if args.attn_diag_cycles > 0:
                metrics.update(_diag_metrics(model))
            if args.use_attn_consist_loss:
                scores = collect_attn_scores(model)
                if scores:
                    ac = attention_consistency_loss(scores, mask,
                                                    model.token_grid)
                    loss = loss + args.attn_consist_w * ac
                    metrics["attn_consist_loss"] = ac
            feat_t = _da_feature(model) if keep else None
            if contrast_bank is not None:
                bank, valid, cls_w = contrast_bank
                k = bank.shape[0]
                if args.task_name == "fundus":
                    ex_mask = torch.cat([mask[..., :1],
                                         mask[..., 1:2] * (1 - mask[..., 2:3]),
                                         mask[..., 2:3]], -1)
                else:
                    ex_mask = mask
                if args.do_neg_contrast and neg_offsets is None:
                    neg_offsets = torch.randint(1, k, (k,), generator=gen,
                                                device=gen.device)
                pos, neg = calc_contrast_losses(
                    feat_t, ex_mask, bank, valid, cls_w,
                    neg_offsets=neg_offsets,
                    do_neg_contrast=args.do_neg_contrast)
                loss = loss + args.contrast_loss_w * (pos - neg)
                metrics["contrast_pos_loss"] = pos
                if args.do_neg_contrast:
                    metrics["contrast_neg_loss"] = neg
            if sup_w != 1.0:
                loss = sup_w * loss
            if recon is not None:
                rl = recon_loss(recon, feat_t, image)
                loss = loss + args.recon_w * rl
                metrics["recon_loss"] = rl
            if disc is not None:
                src = batch["source_image"]
                src_draws = (global_rows(draw_2d, src.shape[0], aug_cfg, gen)
                             if src_draws is None else src_draws)
                src, _ = augment_batch_2d(
                    src, torch.zeros(src.shape[:3] + (1,), device=src.device),
                    src_draws, aug_cfg, *src_stats)
                # JAX keeps the target pass's running statistics
                with frozen_running_stats(model):
                    src_logits = model(resize_linear(src, patch))
                if feat_mode:
                    feat_s = _da_feature(model)
                else:
                    feat_s = torch.sigmoid(src_logits)
                    feat_t = torch.sigmoid(logits)
                if args.adda:
                    # each call starts from the pre-step statistics; the
                    # last one's are kept
                    with frozen_running_stats(disc):
                        d_loss = domain_adversarial_loss(
                            disc, feat_s.detach(), feat_t.detach())
                    g_loss = domain_adversarial_loss(frozen_disc_call,
                                                     feat_t, feat_s)
                    loss = loss + d_loss + args.domain_loss_w * g_loss
                    metrics["disc_loss"] = d_loss
                    metrics["domain_loss"] = g_loss
                else:
                    dl = domain_adversarial_loss(disc, feat_s, feat_t)
                    loss = loss + args.domain_loss_w * dl
                    metrics["domain_loss"] = dl
            if vcdr:
                probs = torch.sigmoid(resize_linear(
                    logits, tuple(mask.shape[1:3])).float())
                calls = []

                def estimate(x):
                    """reference estimate_vcdr (train2d.py:655-664); the
                    running statistics move on the step's last call."""
                    ctx = (frozen_running_stats(aux) if not calls
                           else contextlib.nullcontext())
                    calls.append(x)
                    with ctx:
                        preds = [m(x)[:, 0] for m in vcdr]
                    raw = (preds[0] / (preds[1] + 1e-6) if len(preds) == 2
                           else preds[0])
                    return torch.sigmoid(raw)

                vl = vcdr_estimation_losses(estimate, probs, mask)
                on_estim = float(count[0] >= args.vcdr_estim_start)
                on_net = float(count[0] >= args.vcdr_net_start)
                vcdr_loss = on_estim * (vl["vcdr_estim_loss"]
                                        + on_net * vl["vcdr_net_loss"])
                loss = loss + sup_w * args.vcdr_w * vcdr_loss
                metrics["vcdr_loss"] = vcdr_loss
                metrics.update(vl)
            metrics["loss"] = loss
        finally:
            model.keep_features = False
            drop_kept_features(model)
        if loss.requires_grad:
            loss.backward()
        average_gradients(params)
        if grad_clip and grad_clip > 0:
            clip_by_global_norm_(params, grad_clip)
        if optimizer is not None:
            optimizer.step()
        count[0] += 1
        return global_metrics({k: v.detach() for k, v in metrics.items()})

    return step


def _logger(log_dir):
    return master_logging(log_dir, "train2d_log.txt",
                          "segtran_tpu_torch.train2d")


def job_dir(args, task) -> str:
    return os.path.join(args.ckptdir, f"{args.net}-{args.task_name}-"
                        f"{','.join(dataset_names(args, task))}-"
                        f"{time.strftime('%m%d%H%M')}")


def _summary_writer(log_dir):
    """TensorBoard's writer where the package imports (rank 0 only), else
    None."""
    if not is_master():
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir)


def _with_source(it, source, args, shard=(0, 1)):
    """Each batch of ``it`` with a 'source_image' batch of --sourcebs from
    the source dataset, whose epochs restart with each pass over the
    target's (seed --seed + 5; JAX train2d.py:654-676); a data-parallel
    rank's rows of it under ``shard``."""
    bs = args.source_batch_size if args.source_batch_size > 0 \
        else args.batch_size
    epoch = 0
    src_it = batch_iterator(source, bs, epoch, seed=args.seed + 5,
                            keys=("image",), shard=shard)
    for batch in it:
        try:
            src = next(src_it)
        except StopIteration:
            epoch += 1
            src_it = batch_iterator(source, bs, epoch, seed=args.seed + 5,
                                    keys=("image",), shard=shard)
            src = next(src_it)
        batch["source_image"] = src["image"]
        yield batch


def log_profile(model, task, device, log):
    """--profile (JAX train2d.py:909-921): the parameters, then one eval
    forward's FLOPs and bytes and its images per second (10 timed calls)
    on a zero batch of one patch."""
    model.eval()
    x = torch.zeros((1,) + tuple(task["patch_size"]) + (3,), device=device)
    log.info("params: %.2fM", count_params(model) / 1e6)
    costs = estimate_flops(model, x)
    log.info("forward FLOPs: %.2fG, bytes: %.2fM", costs["flops"] / 1e9,
             costs["bytes"] / 1e6)
    fps = measure_fps(model, x, iters=10)
    log.info("forward FPS (bs=%d): %.2f imgs/s", x.shape[0],
             fps * x.shape[0])


def train(model, dataset, args, task, device, cfg=None, ckpt_dir=None,
          log=None, source_dataset=None):
    """Train ``model`` (initialised, on ``device``) on any dataset of the
    ``data/datasets2d.py`` schema for --maxiter steps; returns the
    checkpoint directory. A multi-``--ds`` run normalises each sample with
    its dataset's table through the samples' 'ds_idx'. With --adv the
    source batches come from ``source_dataset`` (default: --sourceds
    under --dataroot); a DA run's checkpoints hold the net with its aux
    modules."""
    ckpt_dir = ckpt_dir or job_dir(args, task)
    log = log or _logger(ckpt_dir)
    if args.profile:
        log_profile(model, task, device, log)
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
    aux = build_aux_modules(args, task, cfg).to(device)
    wrapped = nn.ModuleDict({"net": model, **aux}) if len(aux) else model
    optimizer, clip = build_train_optimizer(wrapped, model, args)
    contrast_bank = None
    if args.ref_feat_cp_path:
        contrast_bank = load_contrast_bank(args, task, device)
        log.info("reference feature bank: %s, %d/%d valid",
                 tuple(contrast_bank[0].shape), int(contrast_bank[1].sum()),
                 contrast_bank[1].numel())
    if "discriminator" in aux:
        if source_dataset is None:
            source_dataset = build_source_dataset(args, task)
        log.info("%d source-domain samples for adversarial DA",
                 len(source_dataset))
        log.info("source-domain stats (%s): mean=%s std=%s",
                 args.source_ds_name, *load_stats(args, args.source_ds_name))
    par = TrainMesh(wrapped, optimizer, args.ndevices, args.tensor_parallel,
                    expert_dim_size=(cfg.num_modes if args.expert_parallel
                                     and cfg is not None else None),
                    grad_accum=args.grad_accum)
    step = par.wrap(make_step(model, par.optimizer, args, task, device,
                              ds_stats, aux, clip, contrast_bank))
    keys = ("image", "mask") + (("ds_idx",) if ds_stats else ())
    writer = _summary_writer(os.path.join(ckpt_dir, "log"))
    meters = AverageMeters()
    iter_num, epoch, t0 = 0, 0, time.time()
    diag_max, diag_clamp = 0.0, 0
    try:
        while iter_num < args.maxiter:
            it = batch_iterator(dataset, args.batch_size, epoch,
                                seed=args.seed, keys=keys, shard=par.shard,
                                microbatches=par.micro)
            if "discriminator" in aux:
                it = _with_source(it, source_dataset, args, par.shard)
            loader = DevicePrefetcher(it, device)
            try:
                for batch in loader:
                    metrics = step(batch)
                    iter_num += 1
                    values = torch.stack(list(metrics.values())).tolist()
                    values = dict(zip(metrics, values))
                    for k, v in values.items():
                        meters.update(k, v)
                        if writer is not None:
                            writer.add_scalar(k, v, iter_num)
                    if iter_num == 1:
                        log.info("first step done in %.1fs",
                                 time.time() - t0)
                    if args.attn_diag_cycles > 0 and "attn_max" in values:
                        diag_max = max(diag_max, values["attn_max"])
                        diag_clamp += int(values["attn_clamped"])
                        if iter_num % args.attn_diag_cycles == 0:
                            # the reference's periodic line and reset
                            # (segtran_shared.py:582-587)
                            log.info("max-attn: %.2f, avg-attn: %.2f, "
                                     "clamp-count: %d", diag_max,
                                     values["attn_avg"], diag_clamp)
                            diag_max, diag_clamp = 0.0, 0
                    if iter_num % args.logiter == 0:
                        log.info("iter %d (%.2f it/s): %s", iter_num,
                                 iter_num / (time.time() - t0),
                                 meters.disp_str(("loss", "ce_loss",
                                                  "dice_loss")))
                        meters.reset_disp()
                    if (iter_num % args.saveiter == 0
                            or iter_num >= args.maxiter):
                        sd = par.state_dict()
                        if is_master():
                            save_checkpoint(ckpt_dir, iter_num, sd, cfg)
                        log.info("saved iter_%d", iter_num)
                    if iter_num >= args.maxiter:
                        break
            finally:
                loader.close()
            epoch += 1
    finally:
        if writer is not None:
            writer.close()
    par.finish()
    log.info("done: %d iters in %.1fs", iter_num, time.time() - t0)
    return ckpt_dir


def _dataset_class(task):
    from ..data.datasets2d import SegCrop, SegWhole
    return {"SegCrop": SegCrop, "SegWhole": SegWhole}[task["ds_class"]]


def build_source_dataset(args, task):
    """The --sourceds dataset of adversarial DA (JAX train2d.py:537-542):
    split 'all', the task's frame size."""
    return _dataset_class(task)(
        base_dir=os.path.join(args.dataroot, args.task_name,
                              args.source_ds_name),
        split="all", mask_num_classes=task["num_classes"],
        binarize=task.get("binarize", False),
        out_size=task["orig_input_size"], seed=args.seed)


def build_datasets(args, task):
    """One SegCrop/SegWhole per --ds name; a ConcatDataset of them for
    more than one."""
    from ..data.datasets2d import ConcatDataset
    datasets = [_dataset_class(task)(
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


def load_into(model, sd, log):
    """The net's part of a checkpoint into ``model`` (a DA run's too); as
    JAX's ``merge_params``, a parameter the checkpoint lacks keeps its
    fresh value (a --polyformer source checkpoint has no K for a target
    run) and one the model lacks is dropped; both are logged."""
    res = model.load_state_dict(net_state_dict(sd), strict=False)
    if res.missing_keys:
        log.info("kept the fresh values of %d tensor(s) the checkpoint "
                 "lacks: %s", len(res.missing_keys), res.missing_keys)
    if res.unexpected_keys:
        log.info("dropped %d checkpoint tensor(s) the model lacks: %s",
                 len(res.unexpected_keys), res.unexpected_keys)


def main(argv=None):
    """Returns the checkpoint directory."""
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    init_multihost(device, verbose=True)
    n_dev = resolve_ndevices(args.ndevices, args.tensor_parallel)
    _refuse_later_slices(args)
    if args.grad_accum > 1 and args.batch_size % args.grad_accum:
        raise ValueError(f"--gradaccum {args.grad_accum} must divide --bs "
                         f"{args.batch_size}")
    if args.grad_accum > 1 and args.use_attn_consist_loss:
        raise ValueError("--gradaccum > 1 is incompatible with "
                         "--attnconsist: the 2D attention-consistency loss "
                         "is batch-joint (shared inconsistent-count "
                         "denominator), so microbatching changes its value")
    check_microbatches(args.batch_size, args.grad_accum, n_dev,
                       args.tensor_parallel)
    if args.tune_bn_only and not args.checkpoint_path:
        raise SystemExit("--tunebn requires --cp <checkpoint to adapt>")
    task = task_settings(args)
    ckpt_dir = from_master(job_dir(args, task))
    log = _logger(ckpt_dir)
    log.info("args: %s", vars(args))
    model, cfg = build_model_and_config(args, task)
    dataset = build_datasets(args, task)
    log.info("%d training samples on %s", len(dataset), device)
    if args.net not in ZOO:
        init_with_reference_schemes(model, cfg, seed=args.seed)
    if args.checkpoint_path:
        path = args.checkpoint_path
        path = path[:-3] if path.endswith(".pt") else path
        load_into(model, load_checkpoint(path, cfg), log)
        log.info("loaded checkpoint %s", args.checkpoint_path)
    return train(model.to(device), dataset, args, task, device, cfg,
                 ckpt_dir, log)


if __name__ == "__main__":
    main()
