#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (segtran_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run:

1. build  -- compile every CUDA source of the port with nvcc (sm_90a), all
   at once; print the card's name and power limit.
2. kernels -- hold each expansion-epilogue kernel against its plain
   PyTorch version at the fundus flagship's shapes (P [8,4,1296,256]; F=1792
   through the per-mode tier's wrapper, F=896 and 448 through the
   all-modes one, both one launch of the full tier's cluster kernel) and
   the private tier (one launch of the same kernel's private tier) at
   every shape its paths give it: mid [1,4,8640,1024] and [1,4,18000,1024]
   (the BraTS volumes), [2,4,1296,F] (the non-reassociated forward) and
   [8,4,1296,F] (the --fused serving forward), F = 1792, 896, 448, and
   the full tier at the BraTS volume without --fused (P [1,4,8640,1024]),
   each timed beside the unfused module chain (for the full tier the
   shared mid first; then private output linear, LayerNorm, learned soft
   aggregate) with the function epilogue_route picks for the shape: the
   fp32 rows are the numbers its fp32 routes rest on; and the flash
   cross-attention
   kernel at the BraTS in/out-squeeze shapes
   (N=8640 and 18000 tokens), a ragged shape, a clamp case and the fundus
   layer-0 in/out-squeeze (D=F=1792; D=448, F=1792), in bf16 and fp32
   (TF32 off for fp32), each launch bit-for-bit repeatable, with its plan
   (slice width, cluster, row or query tile, grid, key splits), the built
   kernel's shared memory and cudaOccupancyMaxActiveClusters, and for the
   flash forward its time at the other slice width; time each, its plain
   version, for the epilogue kernels the products alone through
   torch.matmul (a yardstick), and for the flash kernels
   scaled_dot_product_attention (forward; forward + backward minus
   forward) with CUDA events.
3. serving -- the InferenceEngine of cli/serve.py at full width (eff-b4,
   3 translayers 1792->1792->896->448, 256 attractors, bf16, --fusedepi,
   576^2 frames through 288^2 patches, --maxbatch 8) from a seeded port
   checkpoint; 16 requests from 4 client threads; the launch counters must
   show 1 per-mode and 2 all-modes launches per forward; one forward is
   profiled (device time by kernel); the same batch through the unfused
   modules must agree.
   The same batch through an engine with --fused --fusedepi (flash
   attention, 6 launches per forward; 3 launches of the private-tier
   epilogue) must agree too; its forward is timed and profiled.
4. non-reassociated forward at batch 2 -- must launch the private-output
   kernel and agree with the unfused modules.
5. whole volume -- the BraTS recipe of cli/test3d.py at full width (I3D,
   1 squeezed translayer 1024->1024, 1024 attractors, bf16, --wholevol
   --fused --fusedepi) from a seeded port checkpoint, through
   evaluate_volume on two synthetic 4-modality volumes (160x192x144 and
   240x240x155); each volume must launch the flash kernel twice and the
   private epilogue once, and agree with the unfused modules; one forward
   is profiled.
6. training -- cli/train3d's train() at full width (I3D, 1 translayer
   1024->1024, 1024 attractors, 4 modes, bf16, --fused --dropout 0) on
   synthetic 240x240x155 volumes held in memory: (a) the recipe crop
   112x112x96 at batch 4, 6 steps, each with 2 flash forward and 2
   recompute-backward launches; (b) a 160x192x144 crop at batch 1, 4
   steps, each with 2 flash forward, 1 flash backward (dK/dV + dQ) and 1
   recompute-backward launch; ms per step, peak memory and one profiled
   step of each; one fp32 step of (b) fused against unfused (loss and
   every gradient); test3d on (a)'s checkpoint. Phase 2 holds the dK/dV
   and dQ kernels (thread-block clusters) against their plain version
   (bf16, fp32), with times, each case's cluster, grids, dQ key splits and
   cudaOccupancyMaxActiveClusters, and times the pair beside the recompute
   backward at the recipe crop's in-squeeze (N = 2352).
7. mbconv -- the fused MBConv front-half kernel against its plain version
   at the five eff-b4 288^2 shapes the fused-eval gate admits, a stride-2
   and an expand_ratio-1 block, at batch 8 in bf16 and fp32 (TF32 off),
   timed beside its plain version and the unfused module chain, each with
   its launch plan, which must match the built kernel's shared memory
   (blocks per SM beside it), and the kernel's ptxas report (registers,
   spills); the eff-b4 backbone at stem stride 1, 288^2, bf16, with
   fused_eval on and off at batch 8 and 32 (17 launches per forward,
   endpoints agree), each forward also profiled (device busy, device
   operations, mbconv_front's share); phase 3's
   batch through the served model with its backbone's fused_eval set (a
   measurement); the fundus Segtran2d train step at full width through
   make_train_step (bs 6 with remat_blocks, bs 24 without: ms per step,
   peak memory, one profiled step) and one fp32 step with remat_blocks on
   against off (loss, gradients, running statistics updated once).

8. fundus CLI -- cli/train2d's train() at the flagship's full width (eff-b4,
   3 translayers 1792->1792->896->448, 4 modes, 256 attractors, bf16, bs 6,
   the default augmentation, remat_blocks by resolve_remat_blocks) on 24
   synthetic 576^2 REFUGE-like frames held in memory, 6 steps to
   iter_6.pt; the CLI step's ms per step, peak memory and the label map +
   augmentation + resize share of its device time beside make_train_step
   alone (and phase 7's bs-6 step); step.augment on the card against the
   same draws on CPU tensors; then cli/test2d's evaluate_checkpoint on
   iter_6.pt over 8 frames at --bs 8 --vcdr with --fusedepi (1 per-mode +
   2 all-modes launches per batch forward), with the unfused modules, and
   with --fused --fusedepi (6 flash + 3 private-tier launches); per-class
   Dice, vCDR error and seconds per frame of each; probabilities within
   MODEL_TOL and per-class Dice within 0.01 of the unfused modules.
9. fundus options -- the flash forward at the new shapes of this phase's
   paths (the non-squeezed encoder's self-attention, G=32, Q=N=1296, in
   its three layers; the oct frame's squeezed layer 0, N=2304) and the
   private tier at mid [8,4,1296,F] against their plain versions (bf16),
   timed beside SDPA and their bounds; then, at the flagship's width
   (eff-b4, 3 translayers 1792->1792->896->448, 4 modes, 256 attractors,
   bf16, seeded weights, a padded batch of 8 288^2 frames) built through
   test2d's factory, each option with --fused --fusedepi against its
   unfused forward (probabilities within MODEL_TOL) with its launches
   checked: (a) --nosqueeze (3 flash forwards at Q = N, 3 private-tier
   launches), (b) --nosqueeze --pos bias (0 flash: JAX's gate), (c)
   --pos rand, --pos sinu, --multihead, --inbn, --gbias, --outfpn 34 (the
   transposed head) and the shared FFN output; (d) test2d's
   evaluate_checkpoint on --task oct over 8 synthetic 288x512 frames
   (--fused --fusedepi against unfused); (e) two train2d.train() steps at
   bs 6 with --nosqueeze --pos bias --inbn on synthetic 576^2 frames (ms
   per step, peak memory); (f) prep_fundus.center_from_model on two
   synthetic 1024^2 frames at --detsize 640 through build_model_fn.

10. volume options -- the flash forward at the 2.5D model's squeezes (D =
   F = 1536; N = 9408, 4704 and 34560 tokens) and the 3-D non-squeezed
   self-attention (Q = N = 2352, 8640, 18000), the flash backward at the
   2.5D in-squeeze (N = 9408) and the 3-D self-attention (N = 8640), and
   the epilogue at F = 1536 (per-mode tier P [1,4,34560,1024], private tier
   mid [1,4,34560,1536]) against their plain versions (bf16), timed beside
   SDPA or the unfused module chain and their bounds; then at full width:
   (b) the 2.5D model (eff-b3, 1 translayer 1536->1536, 1024 attractors, 4
   modes, stemconv on 4 modalities, bf16, --fused --dropout 0) through
   train3d's train(), 3 steps at the 112x112x96 crop at bs 4 (2 flash
   forwards, 1 flash backward pair, 1 recompute backward each; ms per step,
   peak memory) and one --dgroup 2 step; (c) test3d --segtran 25d
   --wholevol on a 160x192x144 volume with --fused --fusedepi (2 flash,
   1 private tier) and --fusedepi (1 per-mode tier), each against the
   unfused modules; (d) the BraTS Segtran3d: --nosqueeze --fused --fusedepi
   whole volumes at 160x192x144 and 240x240x155 against the unfused
   modules, one --nosqueeze train() step at 160x192x144 (the flash
   backward), --pos rand | sinu | bias forwards, two train() steps each of
   --into3 avgto3, --outdrop --dropout 0.1, --outfpn 34 and --attnconsist
   (launches as JAX's gate gives), atria and msd (--mod 0 --xyzpermute
   1,2,0) through train() and evaluate_volume, and one --testinterp
   volume.

11. da -- domain adaptation, the Polyformer and the mince layers through
   train2d's train() on synthetic 576^2 frames (bf16): (a) --net
   unet-scratch --polyformer source (64->512 channels, 256 attractors, 4
   modes, 288^2 patches, bs 6), 3 steps; --polyformer target --targetopt
   k --adv feat --reconweight 0.1 from its checkpoint with a second
   synthetic set as the source, 3 steps: only K's two tensors (and
   running statistics) move, the discriminator and recon head included,
   and no flash kernel launches; test2d and one served batch on it; (b)
   the flagship with --adv feat --fused --dropout 0 at bs 6 and
   --sourcebs 6, 3 steps of 12 flash forwards each (6 per pass, target
   and source), ms per step and peak memory, one fp32 step with --fused
   against two without; (c) two steps each of --adv mask, --adda, --vcdr
   sep, --attnconsist (no flash: JAX's gate), --attndiag 1, --tunebn
   (parameters bit-identical, statistics moved) and --contrastweight
   --negcontrast --reffeatcp with a seeded bank; (d) --nosqueeze --mince
   --mincescales 2,1 --minceprops 1,1: test2d with --fused (no flash) and
   two train steps.

12. zoo -- the kernels at the shapes of Segtran2d on ResNet-101 (--bb
   resnet101, translayers 2048 -> 2048 -> 1024 -> 512, 4 modes, 256
   attractors, batch 8 of 288^2 patches, N = 1296): the flash forward at
   its six calls' shapes (in-squeeze D = F = 2048 and 1024; out-squeeze
   D = 512, 512, 256 with F = 2048, 1024, 512), the full tier (per-mode at
   F = 2048 and 1024, all modes at 512) and the private tier (F = 1024,
   512) against their plain versions in bf16 and fp32, with plans, timed
   beside SDPA / the unfused chain and their bounds; (b) that model at full
   width through test2d's factory (bf16, seeded, a batch of 8) with
   --fusedepi (2 per-mode + 1 all-modes launches) and --fused --fusedepi
   (6 flash + 2 private-tier launches) against the unfused modules, timed,
   one forward profiled; (c) train2d.train() --bb resnet101 --fused
   --dropout 0 at bs 6 on synthetic 576^2 frames, 3 steps (6 flash
   forwards each, no flash backward), ms per step and peak memory; (d)
   every zoo net at its published width through the CLIs (unet on eff-b4
   and resnet34, nestedunet, unet3plus, attunet, r2attunet, dunet,
   transunet R50-ViT-B/16, setr ViT-L, deeplabv3 and deeplabv3plus on
   resnet101, pranet, nnunet): 2 train2d.train() steps at bs 6 (bf16), ms
   per step and peak memory, test2d.evaluate_checkpoint on 8 frames, and
   the checkpoint's fp32 eval forward on the card against the CPU (max
   |probability diff| <= 1e-3, TF32 off); no kernel launches; (e) the
   3-D zoo at its published widths (VNet: 16 filters, group norm;
   Modified3DUNet: 8 base filters; 4 modalities, the BraTS classes,
   bf16): 2 train3d.train() steps at the recipe crop 112x112x96, bs 4, on
   synthetic volumes (ms per step, peak memory), test3d's evaluate_volume
   on a 160x192x144 volume with --wholevol and with the sliding window,
   the fp32 eval forward on the card against the CPU on a 64x64x32 crop
   (<= 1e-3, TF32 off); no kernel launches.

13. import -- reference-format .pth files written from seeded port
   weights (tests/_torch_refsd.py) through convert.cli --strict, each
   import timed, the imported state_dict equal to the seeded one tensor
   for tensor and its probabilities within 1e-6 of the seeded model's:
   (a) the BraTS Segtran3d recipe, then test3d --wholevol --fused
   --fusedepi --bf16 on a 160x192x144 volume (2 flash forwards, 1 private
   tier); (b) the fundus flagship, then a batch of 8 288^2 patches with
   --fusedepi --bf16 (1 per-mode, 2 all-modes launches); (c) the
   importer's VNet and Modified3DUNet on a 112x112x96 crop.

14. tools -- the analysis tools at the flagship's full width (eff-b4, 3
   translayers 1792->1792->896->448, 4 modes, 256 attractors, 288^2
   patches, weights scaled by fan-in from a seed): (a) test2d's --flop
   unfused, with --fusedepi (equal counts) and with --fused --fusedepi
   (equal to the same route with each kernel's plain version in its
   place; the kernels launch in the counted forward), and test3d's on
   the BraTS Segtran3d; (b) layer_receptive_fields with --fused in fp32
   (TF32 off) on every kept layer: 6 flash forward launches per probe
   (counters and profiler), each map timed, card against CPU; (c) test2d
   --robust on 4 frames with --fusedepi and --fused --fusedepi (launches
   per forward checked) against the unfused modules; (d)
   evaluate_checkpoint with --savefeat 2 --removefrag, --testinterp 72
   (with and without --removefrag: one disc per frame, unchanged) and
   neither on 8 synthetic 576^2 frames; (e) train2d.train() --profile at
   bs 6 (parameters, FLOPs, FPS logged) and profile_trace around one
   forward (a trace file written).

15. parallel -- parallel/ on an NCCL group of world size 1, joined by
   ``parallel/multihost.init_multihost`` from the env a ``torchrun
   --nproc_per_node 1`` launch sets (no fallback to gloo or no group) and
   destroyed at the end: (a) train3d's train() at BraTS full width (I3D,
   1 translayer 1024->1024, 1024 attractors, 4 modes, bf16, --fused
   --dropout 0, --ndevices 1) on in-memory volumes at the 160x192x144
   crop, bs 1, 3 steps of 2 flash forwards, 1 dK/dV + dQ pair and 1
   recompute backward each; the step with and without the group timed in
   turns on the same draws (ms per step, peak memory); one fp32 step with
   the group against one without (the loss, and the whole gradient by
   relative Frobenius error <= 1e-5, or <= 3x a repeated run's own where
   the step's atomics make that larger); (b) train2d's train() at the flagship's full width with
   --fused --dropout 0, bs 6, 3 steps of 6 flash forwards each, the step
   with and without the group in turns on the same draws; (c) sharded_whole_volume_apply
   on a 160x192x144 volume with --fused --fusedepi (2 flash forwards + 1
   private tier), probabilities against the model's own forward and
   evaluate_volume through it; (d) sharded_cross_attention at the BraTS
   in-squeeze and token_sharded_expand_attention at its out-squeeze, bf16
   and fp32 (TF32 off), each against the plain flash version and timed
   beside a bare fused_cross_attention call.

Before the last line it prints a JSON object with the fundus train step's
and the fused backbone's numbers, one with the per-kernel numbers, and the
card's ``name, power.limit``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA GPU, or without the
port's sources beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import math
import os
import shutil
import subprocess
import sys
import threading
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
SERVE_ARGV = ["--task", "fundus", "--net", "segtran", "--bb", "eff-b4",
              "--translayers", "3", "--layercompress", "1,1,2,2",
              "--attractors", "256", "--bf16", "--maxbatch", "8",
              "--batchwait", "10", "--device", "cuda"]
# H100 SXM data sheet: dense bf16 tensor-core and fp32 CUDA-core peaks, HBM
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12
# kernel vs plain version, as (max of |err| / (1 + |plain|), mean |err|):
# both round at the same points, but their fp32 sums run in other orders,
# which can move a bf16 rounding by one ulp (2^-8 relative) and carry it
# through LayerNorm and the pool; fp32 differs only in summation order
KERNEL_TOL = {"bf16": (3e-2, 4e-3), "fp32": (1e-4, 1e-5)}
# fused vs unfused model, bf16 probabilities in [0, 1]: the two paths round
# at different places (kernel tiles vs PyTorch ops) through three layers
MODEL_TOL = (0.1, 5e-3)                                       # (max, mean)
# the expansion-epilogue kernel's name in a profile (both tiers)
EPILOGUE_KERNELS = ("mid_pool_kernel",)
# (wrapper, kind, B, M, N, A, F): the full tier at the fundus flagship's
# three widths (P [8,4,1296,256]); the private tier at the BraTS volumes
# (1 launch each), the non-reassociated fundus forward at batch 2 and the
# --fused serving forward at batch 8 (3 launches each, one per width).
# The seed of a case's inputs is its index.
EPILOGUE_CASES = [
    ("fused_mid_output_pool_permode", "mid", 8, 4, 1296, 256, 1792),
    ("fused_mid_output_pool", "mid", 8, 4, 1296, 256, 896),
    ("fused_mid_output_pool", "mid", 8, 4, 1296, 256, 448),
    ("fused_private_output_pool", "private", 2, 4, 1296, 0, 896),
    ("fused_private_output_pool", "private", 1, 4, 8640, 0, 1024),
    ("fused_private_output_pool", "private", 1, 4, 18000, 0, 1024),
    ("fused_private_output_pool", "private", 2, 4, 1296, 0, 1792),
    ("fused_private_output_pool", "private", 2, 4, 1296, 0, 448),
    ("fused_private_output_pool", "private", 8, 4, 1296, 0, 1792),
    ("fused_private_output_pool", "private", 8, 4, 1296, 0, 896),
    ("fused_private_output_pool", "private", 8, 4, 1296, 0, 448),
    # the full tier at the BraTS whole volume without --fused (P
    # [1,4,8640,1024]), the route's per-mode tier in bf16 and fp32
    ("fused_mid_output_pool_permode", "mid", 1, 4, 8640, 1024, 1024)]


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise RuntimeError(msg)


def card_line(torch):
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        if r.returncode == 0 and r.stdout.strip():
            return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return f"{torch.cuda.get_device_name(0)}, power limit not readable"


def cuda_ms(torch, fn, iters, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------ phase 2 ----

def epilogue_inputs(torch, kind, b, m, n, a, f, dt, seed):
    """Activations in the compute dtype, parameters in fp32 (as the model
    holds them)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"

    def rn(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device=dev) * s
    # ws at the feat2score init scale, normal(0.02): mode scores of O(1).
    # (At 0.2 the scores reach ~10, and where two modes nearly tie, a
    # one-ulp bf16 flip of a row's LayerNorm scale moves the pool weight by
    # a visible amount, in either version alike.)
    p = dict(w2=rn(m, f, f, s=1 / math.sqrt(f)), b2=rn(m, f, s=0.1),
             scale=torch.rand(f, generator=g, device=dev) + 0.5,
             lnb=rn(f, s=0.1), ws=rn(f, 1, s=0.02), bs=rn(1))
    if kind == "private":
        return [rn(b, m, n, f, s=0.5).to(dt)] + [p[k] for k in (
            "w2", "b2", "scale", "lnb", "ws", "bs")]
    # scaled so that z = mid W2 + b2 has a row spread of ~0.2-0.5, like the
    # LayerNorm inputs of a layer; a much flatter row lets LayerNorm blow
    # a one-ulp bf16 flip of z up to many ulps of l
    probs = torch.softmax(rn(b, m, n, a, s=4.0), dim=-1).to(dt)
    return [probs, rn(b, m, a, f, s=2.0).to(dt), rn(f, s=0.1)] + [
        p[k] for k in ("w2", "b2", "scale", "lnb", "ws", "bs")]


def epilogue_work(kind, b, m, n, a, f, args):
    """(FLOP, bytes): the matrix products of the function, and each input
    read once plus the [B, N, F] output written once."""
    flops = 2 * b * m * n * f * (f if kind == "private" else a + f)
    nbytes = sum(t.numel() * t.element_size() for t in args)
    nbytes += b * n * f * args[0].element_size()
    return flops, nbytes


def epi_launch_shape(torch, epi, name, dname, b, m, n, a, f, dt):
    """Log the plan (width, cluster, row tile, grid, waves; A = 0: the
    private tier) and cudaOccupancyMaxActiveClusters; the built kernel's
    shared memory must be the plan's."""
    plan = epi._epi_plan(b, m, n, a, f, dt, epi._sm_count("cuda"))
    occ = epi.epi_occupancy(plan, dt)
    log(f"[kernels] {name} {dname} F={f}: clusters of {plan.cluster} CTAs "
        f"x {plan.width} columns, row tiles of {plan.tile}, grid "
        f"{plan.grid} ({plan.waves} waves at one CTA per SM); smem "
        f"{occ['smem']} B; max active clusters {occ['max_active_clusters']}")
    if occ["smem"] != plan.smem:
        fail(f"{name} {dname} F={f}: the kernel takes {occ['smem']} bytes "
             f"of shared memory, the plan {plan.smem}")
    return dict(width=plan.width, cluster=plan.cluster, tile=plan.tile,
                grid=list(plan.grid), waves=plan.waves, smem=plan.smem,
                max_active_clusters=occ["max_active_clusters"])


def products_call(torch, kind, args):
    """The function's matrix products alone through torch.matmul, in the
    compute dtype, at the same shapes: P VW1 then mid W2 (mid kind), or
    mid W2 (private kind). A yardstick of the tensor work, not a call that
    computes the function."""
    dt = args[0].dtype
    if kind == "private":
        mid, w2 = args[0], args[1].to(dt)
        return lambda: torch.matmul(mid, w2)
    probs, vw1, w2 = args[0], args[1], args[3].to(dt)
    return lambda: torch.matmul(torch.matmul(probs, vw1), w2)


def unfused_call(torch, kind, args):
    """The function through the model's unfused modules, the path
    ``epilogue_route`` takes as "unfused": for the full tier the shared
    mid (P VW1 + b1, gelu: MMSharedMid's "post" stage) first; then the
    private output linear (MMPrivateOutput, residual dropped) with its
    LayerNorm and the learned soft aggregate over the modes. A yardstick,
    several PyTorch calls."""
    from segtran_tpu_torch.nn.attention import (LearnedSoftAggregate,
                                                MMPrivateOutput, MMSharedMid)
    if kind == "private":
        act, (w2, b2, scale, lnb, ws, bs) = args[0], args[1:]
    else:
        act, (b1, w2, b2, scale, lnb, ws, bs) = args[:2], args[2:]
    m, f, dt = w2.shape[0], w2.shape[-1], args[0].dtype
    dev = w2.device
    out = MMPrivateOutput(m, f, False, 1e-12, dt).to(dev).eval()
    agg = LearnedSoftAggregate(f, 1, dt).to(dev).eval()
    shared = MMSharedMid(f, dt).to(dev).eval()
    with torch.no_grad():
        out.group_linear.weight.copy_(w2)
        out.group_linear.bias.copy_(b2)
        out.resout_norm_layer.weight.copy_(scale)
        out.resout_norm_layer.bias.copy_(lnb)
        agg.feat2score.weight.copy_(ws.t())
        agg.feat2score.bias.copy_(bs)
        if kind != "private":
            shared.shared_linear.bias.copy_(b1)

    def call():
        with torch.inference_mode():
            mid = act if kind == "private" else shared(
                torch.matmul(act[0], act[1]), stage="post")
            return agg(out(mid, None))
    return call


def check_kernels(torch, epi, only=None, dtypes=("bf16", "fp32"),
                  cases=None):
    """Each ``cases`` entry (EPILOGUE_CASES unless given; those whose index
    is in ``only``, where given) in each of ``dtypes`` against its plain
    version, timed."""
    results = []
    cases = EPILOGUE_CASES if cases is None else cases
    for dname, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        if dname not in dtypes:
            continue
        # plain fp32 references without TF32: full-precision products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        for i, (name, kind, b, m, n, a, f) in enumerate(cases):
            if only is not None and i not in only:
                continue
            args = epilogue_inputs(torch, kind, b, m, n, a, f, dt, seed=i)
            kern = getattr(epi, name)
            plain = getattr(epi, name + "_plain")
            launch = epi_launch_shape(torch, epi, name, dname, b, m, n, a, f,
                                      dt)
            out = kern(*args)
            out2 = kern(*args)
            repeat = bool(torch.equal(out, out2))
            ref = plain(*args)
            torch.cuda.synchronize()
            del out2
            if out.shape != (b, n, f) or out.dtype != dt:
                fail(f"{name} {dname}: got {tuple(out.shape)} {out.dtype}")
            err = (out.float() - ref.float()).abs()
            max_err, mean_err = float(err.max()), float(err.mean())
            rel_err = float((err / (1 + ref.float().abs())).max())
            tol_max, tol_mean = KERNEL_TOL[dname]
            ms = cuda_ms(torch, lambda: kern(*args), iters=5)
            plain_ms = cuda_ms(torch, lambda: plain(*args), iters=3)
            products_ms = cuda_ms(torch, products_call(torch, kind, args),
                                  iters=5)
            unfused = unfused_call(torch, kind, args)
            unfused_err = float((unfused().float() - ref.float()).abs().max())
            unfused_ms = cuda_ms(torch, unfused, iters=5)
            del unfused
            route = epi.epilogue_route(kind, m, a, f, dt)
            flops, nbytes = epilogue_work(kind, b, m, n, a, f, args)
            t_ops, t_bytes = flops / PEAK_FLOPS[dname], nbytes / PEAK_BYTES
            row = dict(name=name, dtype=dname, shape=[b, m, n, a, f],
                       max_abs_err=max_err, mean_abs_err=mean_err,
                       max_rel_err=rel_err,
                       ms=ms, plain_ms=plain_ms, products_ms=products_ms,
                       unfused_ms=unfused_ms, route=route,
                       bound_ms=max(t_ops, t_bytes) * 1e3,
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       flop=flops, bytes=nbytes, repeatable=repeat,
                       launch=launch)
            results.append(row)
            log(f"[kernels] {name} {dname} B,M,N,A,F={b},{m},{n},{a},{f}: "
                f"max_abs_err {max_err:.3e} max |err|/(1+|plain|) "
                f"{rel_err:.3e} mean_abs_err {mean_err:.3e} (tol "
                f"{tol_max:g}/{tol_mean:g}), repeat "
                f"{'bit-identical' if repeat else 'DIFFERS'}; kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, products alone "
                f"(torch.matmul) {products_ms:.4f} ms, "
                + f"unfused module chain {unfused_ms:.4f} ms (max |chain - "
                f"plain| {unfused_err:.3e}; epilogue_route: {route}), "
                + f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
                f"library_ms null: no single PyTorch call computes this "
                f"function")
            if not (rel_err <= tol_max and mean_err <= tol_mean):
                fail(f"{name} {dname} disagrees with its plain version")
            if not repeat:
                fail(f"{name} {dname}: two launches on the same inputs "
                     f"differ")
            del args, out, ref
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    return results


# (G, Q, N, D, F, q/k scale): the BraTS whole-volume in-squeeze
# (attractors <- tokens) and out-squeeze (tokens <- attractors, V W1) at
# 160x192x144 (N=8640) and 240x240x160 (N=18000), a ragged shape and
# scores far beyond the clip
FLASH_CASES = [("in-squeeze N=8640", 1, 1024, 8640, 1024, 1024, 1.0),
               ("out-squeeze N=8640", 4, 8640, 1024, 256, 1024, 1.0),
               ("in-squeeze N=18000", 1, 1024, 18000, 1024, 1024, 1.0),
               ("out-squeeze N=18000", 4, 18000, 1024, 256, 1024, 1.0),
               ("ragged", 3, 1000, 1333, 200, 264, 1.0),
               ("clamp", 1, 256, 512, 64, 64, 30.0)]
# the two flash calls of layer 0 of the --fused fundus serving forward at
# batch 8 (nn/attention._flash): the in-squeeze (256 attractors <- 1296
# tokens, D=F=1792) and the out-squeeze (4 modes of D=448, V W1 F=1792)
FLASH_FUNDUS_CASES = [("fundus in-squeeze", 8, 256, 1296, 1792, 1792, 1.0),
                      ("fundus out-squeeze", 32, 1296, 256, 448, 1792, 1.0)]
# the flash calls of phase 9's new paths at batch 8: the non-squeezed
# encoder's self-attention (Q = N = 1296 tokens, 4 modes) in its three
# layers, and the oct frame's squeezed layer 0 (N = 2304 tokens)
FLASH_OPTION_CASES = [
    ("nosqueeze layer 0", 32, 1296, 1296, 448, 1792, 1.0),
    ("nosqueeze layer 1", 32, 1296, 1296, 448, 896, 1.0),
    ("nosqueeze layer 2", 32, 1296, 1296, 224, 448, 1.0),
    ("oct in-squeeze", 8, 256, 2304, 1792, 1792, 1.0),
    ("oct out-squeeze", 32, 2304, 256, 448, 1792, 1.0)]


def sdpa_call(torch, q, k, v, scale):
    """The first fused backend of scaled_dot_product_attention that takes
    these inputs as [1, G, L, E] (MATH last), as (backend name, call)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        def call(be=be):
            with sdpa_kernel(be):
                return F.scaled_dot_product_attention(q[None], k[None],
                                                      v[None], scale=scale)
        try:
            with warnings.catch_warnings():   # each refusal warns its reason
                warnings.simplefilter("ignore")
                call()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return be.name, call
    fail("no scaled_dot_product_attention backend took the inputs")


def fwd_launch_shape(torch, sa, label, dname, g, nq, n, d, f, dt):
    """Log the forward kernel's plan (width, cluster, grid, key splits) and
    cudaOccupancyMaxActiveClusters; the built kernel's shared memory must
    be the plan's."""
    plan = sa._fwd_plan(g, nq, n, d, f, dt, sa._sm_count("cuda"))
    occ = sa.fwd_occupancy(plan, dt)
    log(f"[flash] {label} {dname}: clusters of {plan.cluster} CTAs x "
        f"{plan.width} columns, {plan.tile} x {plan.key_tile} cells, scores "
        f"in {plan.halves} key half(s), grid {plan.grid} ({plan.splits} key "
        f"splits of {plan.split_tiles} tiles); smem "
        f"{occ['smem']} B; max active clusters "
        f"{occ['max_active_clusters']}")
    if occ["smem"] != plan.smem:
        fail(f"flash forward {label} {dname}: the kernel takes "
             f"{occ['smem']} bytes of shared memory, the plan {plan.smem}")
    return dict(cluster=plan.cluster, width=plan.width, tile=plan.tile,
                key_tile=plan.key_tile, halves=plan.halves,
                grid=list(plan.grid), splits=plan.splits, smem=plan.smem,
                max_active_clusters=occ["max_active_clusters"])


def check_flash(torch, sa, cases=None, dtypes=("bf16", "fp32")):
    """The forward kernel against its plain version (out, lse), bit-for-bit
    repeatability, the launch shape, and times: kernel, plain, SDPA,
    bound, and the kernel at the other slice width (128 <-> 256, where its
    cluster fits), which must agree too. ``cases``: FLASH_CASES and
    FLASH_FUNDUS_CASES unless given."""
    results = []
    cases = FLASH_CASES + FLASH_FUNDUS_CASES if cases is None else cases
    torch.backends.cuda.matmul.allow_tf32 = False
    for dname, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        if dname not in dtypes:
            continue
        for i, (label, g, nq, n, d, f, qk) in enumerate(cases):
            launch = fwd_launch_shape(torch, sa, label, dname, g, nq, n, d,
                                      f, dt)
            gen = torch.Generator(device="cuda").manual_seed(100 + i)

            def rn(*shape, s=1.0):
                return (torch.randn(*shape, generator=gen, device="cuda")
                        * s).to(dt)
            q, k, v = rn(g, nq, d, s=qk), rn(g, n, d, s=qk), rn(g, n, f)
            scale = 1.0 / math.sqrt(d)
            out, lse = sa.fused_cross_attention(q, k, v, return_lse=True)
            out2, lse2 = sa.fused_cross_attention(q, k, v, return_lse=True)
            repeat = bool(torch.equal(out, out2) and torch.equal(lse, lse2))
            ref, ref_lse = sa.fused_cross_attention_plain(q, k, v, 500.0,
                                                          scale)
            torch.cuda.synchronize()
            if out.shape != (g, nq, f) or out.dtype != dt:
                fail(f"flash {label} {dname}: got {tuple(out.shape)} "
                     f"{out.dtype}")
            err = (out.float() - ref.float()).abs()
            max_err, mean_err = float(err.max()), float(err.mean())
            rel_err = float((err / (1 + ref.float().abs())).max())
            lse_err = float((lse - ref_lse).abs().max())
            tol_max, tol_mean = KERNEL_TOL[dname]
            ms = cuda_ms(torch, lambda: sa.fused_cross_attention(q, k, v),
                         iters=5)
            alt = 256 if launch["width"] == 128 else 128
            alt_ms = alt_rel = None
            if max(-(-d // alt), -(-f // alt)) <= 8:
                alt_out, _ = sa._launch_fwd(q, k, v, 500.0, scale, alt)
                alt_rel = float(((alt_out.float() - ref.float()).abs()
                                 / (1 + ref.float().abs())).max())
                alt_ms = cuda_ms(torch, lambda: sa._launch_fwd(
                    q, k, v, 500.0, scale, alt), iters=5)
                del alt_out
            plain_ms = cuda_ms(torch, lambda: sa.fused_cross_attention_plain(
                q, k, v, 500.0, scale), iters=3)
            backend, sdpa = sdpa_call(torch, q, k, v, scale)
            library_ms = cuda_ms(torch, sdpa, iters=3)
            flops = 2 * g * nq * n * (d + f)
            nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) \
                * out.element_size() + lse.numel() * 4
            t_ops, t_bytes = flops / PEAK_FLOPS[dname], nbytes / PEAK_BYTES
            row = dict(name="fused_cross_attention", dtype=dname, case=label,
                       shape=[g, nq, n, d, f], max_abs_err=max_err,
                       mean_abs_err=mean_err, max_rel_err=rel_err,
                       lse_max_abs_err=lse_err, repeatable=repeat, ms=ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       library_backend=backend,
                       bound_ms=max(t_ops, t_bytes) * 1e3,
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       flop=flops, bytes=nbytes, alt_width=alt,
                       alt_width_ms=alt_ms, alt_width_max_rel_err=alt_rel,
                       **launch)
            results.append(row)
            alt_note = (f"width {alt}: {alt_ms:.4f} ms (err {alt_rel:.3e})"
                        if alt_ms is not None else f"width {alt}: no plan")
            log(f"[flash] {label} {dname} G,Q,N,D,F={g},{nq},{n},{d},{f}: "
                f"max |err|/(1+|plain|) {rel_err:.3e} mean_abs_err "
                f"{mean_err:.3e} (tol {tol_max:g}/{tol_mean:g}), lse "
                f"{lse_err:.3e}, repeatable {repeat}; kernel {ms:.4f} ms "
                f"(width {launch['width']}; {alt_note}), plain "
                f"{plain_ms:.4f} ms, sdpa[{backend}] {library_ms:.4f} ms, "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
                f"{flops:.3e} FLOP, {nbytes:.3e} B)")
            if not (rel_err <= tol_max and mean_err <= tol_mean
                    and lse_err <= 1e-3):
                fail(f"flash {label} {dname} disagrees with its plain version")
            if alt_rel is not None and alt_rel > tol_max:
                fail(f"flash {label} {dname} at width {alt} disagrees with "
                     f"its plain version")
            if not repeat:
                fail(f"flash {label} {dname} is not repeatable")
            del q, k, v, out, lse, out2, lse2, ref, ref_lse
        torch.cuda.empty_cache()
    return results


# (G, Q, N, D, F, q/k scale): the in-squeeze of a 160x192x144 and a
# 240x240x160 training crop (the only flash backward of the BraTS train
# step), a ragged shape and scores far beyond the clip
FLASH_BWD_CASES = [("in-squeeze N=8640", 1, 1024, 8640, 1024, 1024, 1.0),
                   ("in-squeeze N=18000", 1, 1024, 18000, 1024, 1024, 1.0),
                   ("ragged", 3, 1000, 4700, 200, 264, 1.0),
                   ("clamp", 1, 256, 512, 64, 64, 30.0)]
# backward kernel vs plain version, as (max |err| / max |plain|, mean |err| /
# mean |plain|) per gradient: bf16 rounds p and ds to bf16 as tensor-core
# operands (2^-9 relative) where the plain version keeps them fp32 (JAX's
# rounding points), then each output rounds to bf16; fp32 differs only in
# summation order
BWD_TOL = {"bf16": (2e-2, 1e-2), "fp32": (1e-4, 1e-5)}
# timing only, bf16: the in-squeeze of the 112x112x96 recipe crop at batch
# 4 (N = 2352 < FLASH_BWD_MIN_N, so training takes the recompute backward
# there): the flash pair beside cross_attention_bwd_recompute
FLASH_BWD_TIMING_CASE = ("recipe crop N=2352", 4, 1024, 2352, 1024, 1024)


def sdpa_backward_call(torch, q, k, v, do, scale):
    """scaled_dot_product_attention forward + backward through autograd on
    [1, G, L, E] copies of q, k, v: (backend, forward call, forward +
    backward call), the first fused backend that takes both (MATH last)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qs, ks, vs = (t.detach()[None].requires_grad_() for t in (q, k, v))
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        def fwd(be=be):
            with sdpa_kernel(be):
                return F.scaled_dot_product_attention(qs, ks, vs, scale=scale)

        def fwd_bwd(be=be):
            torch.autograd.grad(fwd(be), (qs, ks, vs), do[None])
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                fwd_bwd()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return be.name, fwd, fwd_bwd
    fail("no scaled_dot_product_attention backend took the inputs")


def bwd_launch_shape(torch, sa, label, dname, g, nq, n, d, f, dt):
    """Log the backward kernels' plan (cluster, grids, dQ key splits) and
    cudaOccupancyMaxActiveClusters of each kernel; the built kernels'
    shared memory must be the plan's."""
    plan = sa._bwd_plan(g, nq, n, d, f, dt, sa._sm_count("cuda"))
    occ = sa.bwd_occupancy(plan, dt)
    log(f"[flash-bwd] {label} {dname}: clusters of {plan.cluster} CTAs x "
        f"{plan.width} columns, {plan.tile}-row tiles; dK/dV grid "
        f"{plan.dkdv_grid}, dQ grid {plan.dq_grid} ({plan.splits} key "
        f"splits of {plan.split_tiles} tiles); smem {occ['dkdv']['smem']} B;"
        f" max active clusters dK/dV {occ['dkdv']['max_active_clusters']}, "
        f"dQ {occ['dq']['max_active_clusters']}")
    if any(occ[x]["smem"] != plan.dkdv_smem for x in occ):
        fail(f"flash backward {label} {dname}: the kernels take {occ} bytes "
             f"of shared memory, the plan {plan.dkdv_smem}")
    return dict(cluster=plan.cluster, width=plan.width, tile=plan.tile,
                dkdv_grid=list(plan.dkdv_grid), dq_grid=list(plan.dq_grid),
                dq_splits=plan.splits, smem=plan.dkdv_smem,
                max_active_clusters={x: occ[x]["max_active_clusters"]
                                     for x in occ})


def time_recipe_crop(torch, sa):
    """FLASH_BWD_TIMING_CASE: the flash pair's time beside the recompute
    backward's on the same inputs (bf16), data for FLASH_BWD_MIN_N."""
    label, g, nq, n, d, f = FLASH_BWD_TIMING_CASE
    gen = torch.Generator(device="cuda").manual_seed(300)
    q, k, v, do = (torch.randn(*shape, generator=gen, device="cuda").to(
        torch.bfloat16) for shape in ((g, nq, d), (g, n, d), (g, n, f),
                                      (g, nq, f)))
    scale = 1.0 / math.sqrt(d)
    launch = bwd_launch_shape(torch, sa, label, "bf16", g, nq, n, d, f,
                              torch.bfloat16)
    out, lse = sa.fused_cross_attention(q, k, v, return_lse=True)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    args = (q, k, v, do, lse, delta, 500.0, scale)
    pair_ms = cuda_ms(torch, lambda: (sa.flash_backward_dkdv(*args),
                                      sa.flash_backward_dq(*args)), iters=3)
    recompute_ms = cuda_ms(torch, lambda: sa.cross_attention_bwd_recompute(
        q, k, v, do, 500.0, scale), iters=3)
    log(f"[flash-bwd] {label} bf16 G,Q,N,D,F={g},{nq},{n},{d},{f} (timing "
        f"only): flash dK/dV + dQ {pair_ms:.4f} ms, recompute backward "
        f"{recompute_ms:.4f} ms")
    del q, k, v, do, out, lse, delta, args
    torch.cuda.empty_cache()
    return dict(name="flash_backward_recipe_crop", dtype="bf16", case=label,
                shape=[g, nq, n, d, f], pair_ms=pair_ms,
                recompute_ms=recompute_ms, **launch)


def check_flash_backward(torch, sa, cases=None, dtypes=("bf16", "fp32")):
    """The dK/dV and dQ kernels against their plain versions on the same
    inputs (the kernel forward's lse, delta = sum dO O), bit-for-bit
    repeatability, the launch shape, and times: kernel, plain, SDPA
    backward, bound; then, for FLASH_BWD_CASES (``cases`` not given), the
    recipe-crop timing."""
    results = []
    timing = cases is None
    cases = FLASH_BWD_CASES if cases is None else cases
    torch.backends.cuda.matmul.allow_tf32 = False
    for dname, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        if dname not in dtypes:
            continue
        for i, (label, g, nq, n, d, f, qk) in enumerate(cases):
            launch = bwd_launch_shape(torch, sa, label, dname, g, nq, n, d,
                                      f, dt)
            gen = torch.Generator(device="cuda").manual_seed(200 + i)

            def rn(*shape, s=1.0):
                return (torch.randn(*shape, generator=gen, device="cuda")
                        * s).to(dt)
            q, k, v = rn(g, nq, d, s=qk), rn(g, n, d, s=qk), rn(g, n, f)
            do = rn(g, nq, f)
            scale = 1.0 / math.sqrt(d)
            out, lse = sa.fused_cross_attention(q, k, v, return_lse=True)
            delta = (do.float() * out.float()).sum(-1, keepdim=True)
            args = (q, k, v, do, lse, delta, 500.0, scale)
            dk, dv = sa.flash_backward_dkdv(*args)
            dq = sa.flash_backward_dq(*args)
            dq_ref = sa.flash_backward_dq_plain(*args)
            dk_ref, dv_ref = sa.flash_backward_dkdv_plain(*args)
            dk2, dv2 = sa.flash_backward_dkdv(*args)
            repeat = bool(torch.equal(dk, dk2) and torch.equal(dv, dv2)
                          and torch.equal(dq, sa.flash_backward_dq(*args)))
            torch.cuda.synchronize()
            errs = {}
            for gname, got, ref in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                                    ("dv", dv, dv_ref)):
                if got.shape != ref.shape or got.dtype != dt:
                    fail(f"flash backward {label} {dname} {gname}: got "
                         f"{tuple(got.shape)} {got.dtype}")
                e = (got.float() - ref.float()).abs()
                r = ref.float().abs()
                errs[gname] = (float(e.max()), float(e.max() / r.max()),
                               float(e.mean() / r.mean()))
            tol_max, tol_mean = BWD_TOL[dname]
            ms_dkdv = cuda_ms(torch, lambda: sa.flash_backward_dkdv(*args),
                              iters=3)
            ms_dq = cuda_ms(torch, lambda: sa.flash_backward_dq(*args),
                            iters=3)
            plain_dkdv = cuda_ms(torch, lambda: sa.flash_backward_dkdv_plain(
                *args), iters=3)
            plain_dq = cuda_ms(torch, lambda: sa.flash_backward_dq_plain(
                *args), iters=3)
            backend, fwd, fwd_bwd = sdpa_backward_call(torch, q, k, v, do,
                                                       scale)
            library_ms = (cuda_ms(torch, fwd_bwd, iters=3)
                          - cuda_ms(torch, fwd, iters=3))
            elt = out.element_size()
            io = (q.numel() + k.numel() + v.numel() + do.numel()) * elt \
                + (lse.numel() + delta.numel()) * 4
            for name, ms, plain_ms, flops, nbytes, grads in (
                    ("flash_backward_dkdv", ms_dkdv, plain_dkdv,
                     2 * g * nq * n * (2 * d + 2 * f),
                     io + (k.numel() + v.numel()) * elt, ("dk", "dv")),
                    ("flash_backward_dq", ms_dq, plain_dq,
                     2 * g * nq * n * (2 * d + f), io + q.numel() * elt,
                     ("dq",))):
                t_ops, t_bytes = flops / PEAK_FLOPS[dname], nbytes / PEAK_BYTES
                row = dict(name=name, dtype=dname, case=label,
                           shape=[g, nq, n, d, f],
                           max_abs_err=max(errs[x][0] for x in grads),
                           max_err_over_max=max(errs[x][1] for x in grads),
                           mean_err_over_mean=max(errs[x][2] for x in grads),
                           repeatable=repeat, ms=ms, plain_ms=plain_ms,
                           library_ms=library_ms, library_backend=backend,
                           bound_ms=max(t_ops, t_bytes) * 1e3,
                           bound_by=("operations" if t_ops >= t_bytes
                                     else "bytes"),
                           flop=flops, bytes=nbytes, **launch)
                results.append(row)
                log(f"[flash-bwd] {name} {label} {dname} "
                    f"G,Q,N,D,F={g},{nq},{n},{d},{f}: max |err|/max |plain| "
                    f"{row['max_err_over_max']:.3e}, mean {row['mean_err_over_mean']:.3e} "
                    f"(tol {tol_max:g}/{tol_mean:g}), repeatable {repeat}; "
                    f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"sdpa[{backend}] backward (all grads) {library_ms:.4f} "
                    f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
                    f"{flops:.3e} FLOP, {nbytes:.3e} B)")
            if not all(e[1] <= tol_max and e[2] <= tol_mean
                       for e in errs.values()):
                fail(f"flash backward {label} {dname} disagrees with its "
                     f"plain version: {errs}")
            if not repeat:
                fail(f"flash backward {label} {dname} is not repeatable")
            del q, k, v, do, out, lse, delta, args, dq, dk, dv
            del dq_ref, dk_ref, dv_ref, dk2, dv2
        torch.cuda.empty_cache()
    if timing:
        results.append(time_recipe_crop(torch, sa))
    return results


# ------------------------------------------------------------ phase 3 ----

def compare(a, b):
    d = abs(a.astype("float64") - b.astype("float64"))
    return float(d.max()), float(d.mean())


def profile_forward(torch, fn, label, groups):
    """Device time by kernel over one call of fn, a forward that ends in a
    synchronisation (torch.profiler, CUPTI): only device-side events
    (kernels and copies) are summed, so operator rows do not count their
    kernels twice; the busy share is that sum over the forward's host wall
    time under the profiler. groups: {name: substring of kernel names, or
    a tuple of them}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # (the optimizer's profiling ranges appear as device rows too; they
    # span kernels counted on their own rows)
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and not e.key.startswith("Optimizer.")), reverse=True)
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        log("[profile] the profiler saw no device time")
        return {}
    split = {g: sum(r[0] for r in rows
                    if any(s in r[2] for s in ((k,) if isinstance(k, str)
                                               else k)))
             for g, k in groups.items()}
    ops = sum(r[1] for r in rows)
    log(f"[profile] {label}: wall {wall_ms:.3f} ms under the "
        f"profiler, device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%), "
        f"{ops} device operations; "
        + ", ".join(f"{g} {v:.3f} ms" for g, v in split.items()))
    for ms, count, key in rows[:15]:
        log(f"[profile]   {ms:9.3f} ms  x{count:<4d} {key[:110]}")
    return dict(profile_wall_ms=wall_ms, profile_device_busy_ms=busy,
                profile_device_ops=ops,
                **{f"profile_{g.replace(' ', '_')}_ms": v
                   for g, v in split.items()})


def serve(torch, np, epi, sa, mb, ckdir, logger):
    from segtran_tpu_torch.cli.serve import (InferenceEngine, build_argparser,
                                             build_model_and_config,
                                             task_settings)
    from segtran_tpu_torch.models.segtran2d import init_segtran2d
    from segtran_tpu_torch.train.checkpoint import save_checkpoint

    argv = SERVE_ARGV + ["--fusedepi", "--cpdir", ckdir, "--iter", "1"]
    args = build_argparser().parse_args(argv)
    model, cfg = build_model_and_config(args, task_settings(args))
    if cfg.translayer_dims != (1792, 1792, 896, 448):
        fail(f"unexpected translayer dims {cfg.translayer_dims}")
    save_checkpoint(ckdir, 1, init_segtran2d(model, seed=0).state_dict(), cfg)
    del model
    engine = InferenceEngine(args, logger)
    rng = np.random.RandomState(0)
    images = [rng.rand(576, 576, 3).astype(np.float32) for _ in range(16)]
    try:
        engine.forward(np.zeros((8, 576, 576, 3), np.float32))   # warm
        answers = {}

        def client(c):
            # like an HTTP handler: read the answer, then let it go (the
            # page-locked block it views is reused by a later batch)
            for j in range(4):
                p = engine.submit(images[4 * c + j])
                p.event.wait()
                answers[4 * c + j] = (
                    p.error, None if p.error else p.probs.shape,
                    p.error is None and bool(np.isfinite(p.probs).all()))

        epi.reset_launches()
        before = engine.stats()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in (
            epi.fused_mid_output_pool_permode, epi.fused_mid_output_pool,
            epi.fused_private_output_pool)}
        st = engine.stats()
        batches = st["batches"] - before["batches"]
        for i, (error, shape, finite) in answers.items():
            if error is not None:
                fail(f"request {i} failed: {error!r}")
            if shape != (576, 576, 3) or not finite:
                fail(f"request {i}: bad answer {shape}, finite {finite}")
        if len(answers) != 16:
            fail(f"{len(answers)} of 16 requests answered")
        log(f"[serving] launches in the served run: {json.dumps(launches)} "
            f"over {batches} forwards")
        if (launches["fused_mid_output_pool_permode"] != batches
                or launches["fused_mid_output_pool"] != 2 * batches
                or launches["fused_private_output_pool"] != 0):
            fail("the served forwards did not run 1 per-mode + 2 all-modes "
                 "epilogue launches each")

        batch = np.stack(images[:8])
        fwd_ms = []
        for _ in range(3):
            t1 = time.perf_counter()
            fused = engine.forward(batch)
            fwd_ms.append((time.perf_counter() - t1) * 1e3)
        perf = dict(requests=16, seconds=wall, requests_per_s=16 / wall,
                    forwards=batches,
                    avg_batch_occupancy=st["avg_batch_occupancy"],
                    latency_ms_p50=st["latency_ms_p50"],
                    latency_ms_p95=st["latency_ms_p95"],
                    batch_ms_p50_served=st["batch_ms_p50"],
                    forward_ms_batch8=sorted(fwd_ms)[1])
        perf.update(profile_forward(
            torch, lambda: engine.forward(batch), "one batch-8 forward",
            {"epilogue kernels": EPILOGUE_KERNELS, "copies": "Memcpy"}))
        # phase 7, a measurement: the same batch with the backbone's
        # fused-eval path (no flag of the CLI sets it)
        for blk in engine.model.backbone._blocks:
            blk.fused_eval = True
        mb.reset_launches()
        fused_bb = engine.forward(batch)
        n_mb = mb.mbconv_front.launches
        bb_ms = []
        for _ in range(3):
            t1 = time.perf_counter()
            engine.forward(batch)
            bb_ms.append((time.perf_counter() - t1) * 1e3)
        perf.update(forward_ms_batch8_fused_backbone=sorted(bb_ms)[1],
                    fused_backbone_mbconv_launches=n_mb)
        log(f"[serving] batch-8 forward with the fused-eval backbone: "
            f"{n_mb} mbconv_front launches, {sorted(bb_ms)[1]:.3f} ms (vs "
            f"{perf['forward_ms_batch8']:.3f} ms)")
        if n_mb == 0 or n_mb % MBCONV_PER_FORWARD:
            fail(f"the fused-eval backbone launched mbconv_front {n_mb} "
                 f"times, not {MBCONV_PER_FORWARD} per model call")
    finally:
        engine.close()
    state = engine.model.state_dict()
    cfg = engine.cfg
    del engine
    torch.cuda.empty_cache()

    unfused_args = build_argparser().parse_args(
        SERVE_ARGV + ["--cpdir", ckdir, "--iter", "1"])
    ref_engine = InferenceEngine(unfused_args, logger)
    try:
        ref = ref_engine.forward(batch)
    finally:
        ref_engine.close()
    del ref_engine
    mx, mean = compare(fused, ref)
    perf.update(fused_vs_unfused_max_abs=mx, fused_vs_unfused_mean_abs=mean)
    log(f"[serving] fused vs unfused probabilities (bf16): max {mx:.3e} "
        f"mean {mean:.3e} (tol {MODEL_TOL[0]:g}/{MODEL_TOL[1]:g})")
    if not (mx <= MODEL_TOL[0] and mean <= MODEL_TOL[1]):
        fail("fused serving forward disagrees with the unfused modules")
    mx, mean = compare(fused_bb, ref)
    perf.update(fused_backbone_vs_unfused_max_abs=mx,
                fused_backbone_vs_unfused_mean_abs=mean)
    log(f"[serving] fused-eval backbone vs unfused probabilities (bf16): max "
        f"{mx:.3e} mean {mean:.3e} (tol {MODEL_TOL[0]:g}/{MODEL_TOL[1]:g})")
    if not (mx <= MODEL_TOL[0] and mean <= MODEL_TOL[1]):
        fail("the fused-eval backbone's forward disagrees with the unfused "
             "modules")

    # --fused: flash attention in all 3 translayers (in-squeeze D=F=1792 at
    # layer 0), the out side through V W1 and the private epilogue
    flash_engine = InferenceEngine(build_argparser().parse_args(
        SERVE_ARGV + ["--fused", "--fusedepi", "--cpdir", ckdir, "--iter",
                      "1"]), logger)
    try:
        epi.reset_launches()
        sa.reset_launches()
        flash = flash_engine.forward(batch)
        n_flash = sa.fused_cross_attention.launches
        n_private = epi.fused_private_output_pool.launches
        flash_ms = []
        for _ in range(3):
            t1 = time.perf_counter()
            flash_engine.forward(batch)
            flash_ms.append((time.perf_counter() - t1) * 1e3)
        perf["fused_forward_ms_batch8"] = sorted(flash_ms)[1]
        perf["fused_profile"] = profile_forward(
            torch, lambda: flash_engine.forward(batch),
            "one --fused --fusedepi batch-8 forward",
            {"epilogue kernels": EPILOGUE_KERNELS,
             "flash forward": ("fwd_kernel", "fwd_merge_kernel")})
    finally:
        flash_engine.close()
    del flash_engine
    torch.cuda.empty_cache()
    mx, mean = compare(flash, ref)
    perf.update(flash_vs_unfused_max_abs=mx, flash_vs_unfused_mean_abs=mean)
    log(f"[serving] --fused --fusedepi: {n_flash} flash and {n_private} "
        f"private-epilogue launches; vs unfused probabilities (bf16): max "
        f"{mx:.3e} mean {mean:.3e} (tol {MODEL_TOL[0]:g}/{MODEL_TOL[1]:g})")
    if n_flash != 6 or n_private != 3:
        fail("the --fused forward did not run 2 flash launches and 1 "
             "private-epilogue launch per translayer")
    if not (mx <= MODEL_TOL[0] and mean <= MODEL_TOL[1]):
        fail("--fused serving forward disagrees with the unfused modules")
    return perf, launches, state, cfg, batch


# ------------------------------------------------------------ phase 4 ----

def nonreassociated(torch, np, epi, state, cfg, batch):
    from segtran_tpu_torch.infer.sliding import sliding_window_2d
    from segtran_tpu_torch.models.segtran2d import Segtran2d
    from segtran_tpu_torch.data.stats import load_dataset_stats

    mean, std = load_dataset_stats("fundus", 0.5, "train")
    dev = torch.device("cuda")
    mean_t = torch.tensor(mean, device=dev)
    std_t = torch.tensor(std, device=dev)
    gray_w = torch.tensor([0.299, 0.587, 0.114], device=dev)

    def run(model, x):
        def fn(im):
            gray = torch.tensordot(im, gray_w, dims=([-1], [0]))[..., None]
            return model((0.5 * im + 0.5 * gray - mean_t) / std_t)
        with torch.inference_mode():
            return sliding_window_2d(fn, x, (576, 576), (288, 288),
                                     num_classes=3).cpu().numpy()

    x = torch.from_numpy(batch[:2]).to(dev)
    outs = {}
    for fusedepi in (True, False):
        c = dataclasses.replace(cfg, reassociate=False,
                                use_fused_epilogue=fusedepi)
        model = Segtran2d(c)
        model.load_state_dict(state, strict=True)
        model = model.to(dev).eval()
        run(model, x)                                      # warm
        epi.reset_launches()
        outs[fusedepi] = run(model, x)
        if fusedepi:
            launches = epi.fused_private_output_pool.launches
            others = (epi.fused_mid_output_pool.launches
                      + epi.fused_mid_output_pool_permode.launches)
        del model
        torch.cuda.empty_cache()
    log(f"[nonreassoc] fused_private_output_pool launches: {launches}")
    if launches != 3 or others != 0:
        fail("the non-reassociated forward did not run the private-output "
             "kernel once per translayer")
    if not np.isfinite(outs[True]).all():
        fail("non-reassociated forward is not finite")
    mx, mean = compare(outs[True], outs[False])
    log(f"[nonreassoc] fused vs unfused probabilities (bf16): max {mx:.3e} "
        f"mean {mean:.3e} (tol {MODEL_TOL[0]:g}/{MODEL_TOL[1]:g})")
    if not (mx <= MODEL_TOL[0] and mean <= MODEL_TOL[1]):
        fail("non-reassociated fused forward disagrees with the unfused one")
    return launches


# ------------------------------------------------------------ phase 5 ----

WHOLEVOL_ARGV = ["--task", "brats", "--translayers", "1", "--attractors",
                 "1024", "--wholevol", "--bf16", "--device", "cuda"]
VOLUMES = [(160, 192, 144), (240, 240, 155)]


def synthetic_volume(np, shape, seed):
    """A 4-modality volume with a zero background outside an ellipsoid
    (so the nonzero mask drops tokens) and nested tumour labels {0,1,2,4}
    ({0,1,2,3} once BratsSet's 4 -> 3 remap is applied, as here)."""
    rng = np.random.RandomState(seed)
    axes = [np.linspace(-1, 1, n, dtype=np.float32) for n in shape]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    head = (x / 0.8) ** 2 + (y / 0.85) ** 2 + (z / 0.9) ** 2 <= 1
    image = rng.rand(*shape, 4).astype(np.float32) * head[..., None]
    r2 = (x - 0.2) ** 2 + (y + 0.1) ** 2 + z ** 2
    label = np.zeros(shape, np.uint8)
    label[r2 < 0.09] = 2
    label[r2 < 0.04] = 1
    label[r2 < 0.01] = 3
    return {"image": image, "label": label}


def wholevol(torch, np, epi, sa, ckdir, logger):
    from segtran_tpu_torch.cli.test3d import (WHOLEVOL_MULTIPLES,
                                              build_argparser,
                                              build_model_and_config,
                                              evaluate_volume, task_settings)
    from segtran_tpu_torch.models.segtran3d import init_segtran3d
    from segtran_tpu_torch.train.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
    dev = torch.device("cuda")
    ck = ["--cpdir", ckdir, "--iters", "1"]
    fused_args = build_argparser().parse_args(
        WHOLEVOL_ARGV + ["--fused", "--fusedepi"] + ck)
    plain_args = build_argparser().parse_args(WHOLEVOL_ARGV + ck)
    task = task_settings(fused_args)
    model, cfg = build_model_and_config(fused_args, task)
    if (cfg.translayer_dims != (1024, 1024) or cfg.num_attractors != 1024
            or cfg.D_pool_K != 2 or cfg.num_modes != 4):
        fail(f"unexpected BraTS config {cfg}")
    save_checkpoint(ckdir, 1, init_segtran3d(model, seed=0).state_dict(), cfg)
    state = load_checkpoint(os.path.join(ckdir, "iter_1"), cfg)
    models = {}
    for name, args in (("fused", fused_args), ("unfused", plain_args)):
        m, _ = build_model_and_config(args, task)
        m.load_state_dict(state, strict=True)
        models[name] = m.to(dev).eval()
    del model

    def run(name, sample):
        args = fused_args if name == "fused" else plain_args
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs, _, metrics = evaluate_volume(models[name], sample, args, task,
                                            dev)
        return probs, metrics, time.perf_counter() - t0

    perf, launches = {}, {"fused_cross_attention": 0,
                          "fused_private_output_pool": 0}
    for vi, shape in enumerate(VOLUMES):
        sample = synthetic_volume(np, shape, seed=vi)
        run("fused", sample)                                   # warm
        torch.cuda.reset_peak_memory_stats()
        epi.reset_launches()
        sa.reset_launches()
        probs, metrics, secs = run("fused", sample)
        n_flash = sa.fused_cross_attention.launches
        n_private = epi.fused_private_output_pool.launches
        n_full = (epi.fused_mid_output_pool.launches
                  + epi.fused_mid_output_pool_permode.launches)
        launches["fused_cross_attention"] += n_flash
        launches["fused_private_output_pool"] += n_private
        tag = "x".join(map(str, shape))
        log(f"[wholevol] {tag}: {secs:.3f} s per volume "
            f"({np.prod(shape) / secs / 1e6:.2f} Mvoxel/s), launches: flash "
            f"{n_flash}, private epilogue {n_private}, full-fusion tiers "
            f"{n_full}; dice (random weights) "
            f"{[round(d, 4) for d in metrics['dice']]}")
        if n_flash != 2 or n_private != 1 or n_full != 0:
            fail(f"the {tag} volume did not run 2 flash launches and 1 "
                 f"private-epilogue launch")
        if probs.shape != shape + (4,) or not bool(torch.isfinite(probs).all()):
            fail(f"the {tag} volume's probabilities are not finite "
                 f"[{shape}, 4]: {tuple(probs.shape)}")
        if not np.isfinite(metrics["dice"]).all():
            fail(f"the {tag} volume's Dice is not finite")

        pad = [(-s) % m for s, m in zip(shape, WHOLEVOL_MULTIPLES)]
        vol = torch.nn.functional.pad(
            torch.from_numpy(sample["image"]).to(dev)[None],
            (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
        fwd = []
        with torch.inference_mode():
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                models["fused"](vol)
                torch.cuda.synchronize()
                fwd.append(time.perf_counter() - t0)
            prof = profile_forward(
                torch, lambda: (models["fused"](vol), torch.cuda.synchronize()),
                f"one {tag} whole-volume forward",
                {"flash forward": "fwd_kernel", "flash merge":
                 "fwd_merge_kernel", "epilogue kernels": EPILOGUE_KERNELS,
                 "group norm statistics": "RowwiseMoments",
                 "trilinear resizes": "upsample_trilinear",
                 "max pools": "max_pool3d"})
        del vol
        ref, _, ref_secs = run("unfused", sample)
        mx, mean = (float(v) for v in ((probs - ref).abs().max(),
                                       (probs - ref).abs().mean()))
        log(f"[wholevol] {tag}: fused vs unfused probabilities (bf16): max "
            f"{mx:.3e} mean {mean:.3e} (tol {MODEL_TOL[0]:g}/"
            f"{MODEL_TOL[1]:g}); unfused {ref_secs:.3f} s per volume")
        if not (mx <= MODEL_TOL[0] and mean <= MODEL_TOL[1]):
            fail(f"the fused {tag} volume disagrees with the unfused modules")
        perf[tag] = dict(seconds_per_volume=secs,
                         voxels_per_s=float(np.prod(shape)) / secs,
                         forward_s=sorted(fwd)[1],
                         unfused_seconds_per_volume=ref_secs,
                         fused_vs_unfused_max_abs=mx,
                         fused_vs_unfused_mean_abs=mean,
                         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                         **prof)
        del probs, ref, sample
        torch.cuda.empty_cache()
    return perf, launches


# ------------------------------------------------------------ phase 6 ----

# (label, train3d flags, steps, per-step launches: flash forward, flash
# backward (dK/dV and dQ each), recompute backward). (a) is the BraTS recipe
# crop (N = 2352 tokens: both squeezes below FLASH_BWD_MIN_N keys); (b) the
# 160x192x144 crop (N = 8640: the in-squeeze takes the flash backward)
TRAIN_CASES = [
    ("recipe 112x112x96 bs4", ["--bs", "4", "--patchsize", "112,112,96"],
     6, (2, 0, 2)),
    ("160x192x144 bs1", ["--bs", "1", "--patchsize", "160,192,144",
                         "--inputsize", "160,192,144"], 4, (2, 1, 1)),
]
TRAIN_ARGV = ["--task", "brats", "--translayers", "1", "--attractors", "1024",
              "--fused", "--dropout", "0", "--device", "cuda", "--seed", "0"]
# fused vs unfused fp32 train step (TF32 off): the loss, and each gradient
# as max |diff| / max |unfused| -- the paths differ in summation order and
# in the kernels' always-clamp, which no score here reaches
TRAIN_TOL = {"loss_rel": 1e-4, "grad": 1e-2}


def synthetic_dataset(np, n, shape):
    """n synthetic BraTS volumes (``synthetic_volume``) behind the training
    BratsSet's crop logic, in memory: the GPU machine has no h5py."""
    from segtran_tpu_torch.data.datasets3d import BratsSet

    class InMemoryBrats(BratsSet):
        def __init__(self, vols, crop_size, seed):
            self.vols, self.case_list = vols, [f"synthetic{i}"
                                               for i in range(len(vols))]
            self.mode, self.crop_size, self.seed, self.epoch = (
                "train", crop_size, seed, 0)
            self.binarize, self.remap_label4 = False, True

        def read(self, idx):
            v = self.vols[idx]
            return v["image"], v["label"]

    vols = [synthetic_volume(np, shape, seed=10 + i) for i in range(n)]
    return lambda crop: InMemoryBrats(vols, crop, seed=0)


def train_step_perf(torch, train3d, model, args, task, dev, batch, label):
    """ms per step (host clock around 3 steps ending in a synchronise, after
    a warm step), peak GB, finite loss and gradients, one profiled step."""
    from segtran_tpu_torch.train.trainer import build_optimizer
    opt = build_optimizer(model, lr=args.lr, decay=args.decay,
                          t_total=args.maxiter, warmup_ratio=0.5)
    step = train3d.make_step(model, opt, args, task, dev)
    step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(3):
        metrics = step(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 3 * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    finite = all(bool(torch.isfinite(v).all()) for v in metrics.values()) \
        and all(p.grad is None or bool(torch.isfinite(p.grad).all())
                for p in model.parameters())
    prof = profile_forward(
        torch, lambda: (step(batch), torch.cuda.synchronize()),
        f"one {label} train step",
        {"flash forward": "fwd_kernel", "flash merge": "fwd_merge_kernel",
         "flash dK/dV": "dkdv_kernel", "flash dQ": "dq_kernel",
         "conv fprop": "fprop", "conv dgrad": "dgrad", "conv wgrad": "wgrad",
         "group norm statistics": "RowwiseMoments",
         "trilinear resizes": "upsample_trilinear",
         "max pools": "max_pool3d", "reductions": "reduce_kernel"})
    return dict(ms_per_step=ms, peak_mem_gb=peak,
                loss=float(metrics["loss"]), finite=finite, **prof)


def fused_vs_unfused_fp32(torch, np, train3d, make_ds, state, extra, dev):
    """One fp32 forward + backward of the (b) batch through --fused and the
    unfused modules on the same weights: the loss and every gradient."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grads, losses = {}, {}
    ds = make_ds((160, 192, 144))
    sample = ds[0]
    image = torch.from_numpy(sample["image"])[None].to(dev)
    label = torch.from_numpy(sample["label"])[None].to(dev)
    for fused in (True, False):
        argv = [a for a in TRAIN_ARGV + extra if fused or a != "--fused"]
        args = train3d.build_argparser().parse_args(argv)
        task = train3d.train_task_settings(args)
        model, _ = train3d.build_model_and_config(args, task)
        model.load_state_dict(state, strict=True)
        model = model.to(dev).train()
        from segtran_tpu_torch.data.labelmaps3d import brats_map_label
        loss, _ = train3d.make_loss_fn(task, args.max_dice_w, dev)(
            model(image), brats_map_label(label))
        loss.backward()
        losses[fused] = float(loss.detach())
        grads[fused] = {n: p.grad.detach().clone()
                        for n, p in model.named_parameters()
                        if p.grad is not None}
        del model, loss
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    loss_rel = abs(losses[True] - losses[False]) / abs(losses[False])
    worst = max(((float((grads[True][n] - g).abs().max())
                  / max(float(g.abs().max()), 1e-30), n)
                 for n, g in grads[False].items()
                 if not n.endswith("feat_softaggr.feat2score.bias")))
    finite = all(bool(torch.isfinite(g).all()) for g in grads[True].values())
    log(f"[train] fp32 fused vs unfused step at 160x192x144: loss "
        f"{losses[True]:.6f} vs {losses[False]:.6f} (rel {loss_rel:.2e}, "
        f"tol {TRAIN_TOL['loss_rel']:g}); worst gradient max |diff| / max "
        f"|unfused| {worst[0]:.2e} ({worst[1]}; tol {TRAIN_TOL['grad']:g}) "
        f"over {len(grads[False])} tensors")
    if len(grads[True]) != len(grads[False]) or not finite:
        fail("the fused fp32 step's gradients are missing or not finite")
    if loss_rel > TRAIN_TOL["loss_rel"] or worst[0] > TRAIN_TOL["grad"]:
        fail("the fused fp32 train step disagrees with the unfused one")
    return dict(fp32_loss_rel=loss_rel, fp32_worst_grad=worst[0],
                fp32_worst_grad_tensor=worst[1])


def training(torch, np, sa, ckdir, logger):
    """Phase 6: train3d's train() at full width on synthetic volumes, both
    configurations, with the launch counts per step; the fp32 fused vs
    unfused check; test3d on the recipe run's checkpoint."""
    from segtran_tpu_torch.cli import train3d
    from segtran_tpu_torch.cli.test3d import (build_argparser as eval_parser,
                                              build_model_and_config,
                                              evaluate_volume, task_settings)
    from segtran_tpu_torch.nn.init import init_with_reference_schemes
    from segtran_tpu_torch.train.checkpoint import load_checkpoint
    dev = torch.device("cuda")
    make_ds = synthetic_dataset(np, 4, (240, 240, 155))
    perf, launches, ckpts = {}, {}, {}
    for label, extra, steps, (n_fwd, n_flash, n_rec) in TRAIN_CASES:
        argv = TRAIN_ARGV + extra + ["--bf16", "--maxiter", str(steps),
                                     "--saveiter", str(steps), "--ckptdir",
                                     ckdir]
        args = train3d.build_argparser().parse_args(argv)
        task = train3d.train_task_settings(args)
        model, cfg = train3d.build_model_and_config(args, task)
        if (cfg.translayer_dims != (1024, 1024) or cfg.num_attractors != 1024
                or cfg.num_modes != 4 or cfg.dtype != torch.bfloat16):
            fail(f"unexpected BraTS training config {cfg}")
        init_with_reference_schemes(model, cfg, seed=0)
        model = model.to(dev)
        ds = make_ds(tuple(task["orig_patch_size"]))
        sa.reset_launches()
        t0 = time.perf_counter()
        ckpt = train3d.train(model, ds, args, task, dev, cfg,
                             os.path.join(ckdir, f"case{len(ckpts)}"), logger)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = (sa.fused_cross_attention.launches,
               sa.flash_backward_dkdv.launches, sa.flash_backward_dq.launches,
               sa.cross_attention_bwd_recompute.launches)
        launches[label] = got
        want = (n_fwd * steps, n_flash * steps, n_flash * steps,
                n_rec * steps)
        log(f"[train] {label}: train() ran {steps} steps in {wall:.2f} s; "
            f"launches flash forward {got[0]}, dK/dV {got[1]}, dQ {got[2]}, "
            f"recompute backward {got[3]} (want {want})")
        if got != want:
            fail(f"{label}: the train steps did not make {n_fwd} flash "
                 f"forward, {n_flash} flash backward and {n_rec} recompute "
                 f"backward launches each")
        ckpts[label] = (ckpt, steps)
        batch = {k: torch.from_numpy(np.stack([ds[i][k] for i in range(
            args.batch_size)])).to(dev) for k in ("image", "label")}
        row = train_step_perf(torch, train3d, model, args, task, dev, batch,
                              label)
        if not row["finite"]:
            fail(f"{label}: the loss or a gradient is not finite")
        perf[label] = row
        if n_flash:
            state = {k: v.float() if v.is_floating_point() else v
                     for k, v in model.state_dict().items()}
        del model, batch
        torch.cuda.empty_cache()
    perf.update(fused_vs_unfused_fp32(torch, np, train3d, make_ds, state,
                                      TRAIN_CASES[1][1] + [
                                          "--maxiter", "4"], dev))
    # test3d on the recipe run's checkpoint: one whole volume
    ckpt, steps = ckpts[TRAIN_CASES[0][0]]
    eargs = eval_parser().parse_args(
        ["--task", "brats", "--translayers", "1", "--attractors", "1024",
         "--wholevol", "--fused", "--fusedepi", "--bf16", "--device", "cuda",
         "--cpdir", ckpt, "--iters", str(steps)])
    etask = task_settings(eargs)
    model, ecfg = build_model_and_config(eargs, etask)
    model.load_state_dict(load_checkpoint(os.path.join(
        ckpt, f"iter_{steps}"), ecfg), strict=True)
    probs, _, metrics = evaluate_volume(model.to(dev).eval(),
                                        synthetic_volume(np, (240, 240, 155),
                                                         seed=99),
                                        eargs, etask, dev)
    log(f"[train] test3d on the recipe checkpoint iter_{steps}: dice "
        f"{[round(d, 4) for d in metrics['dice']]}")
    if not bool(torch.isfinite(probs).all()) or \
            not np.isfinite(metrics["dice"]).all():
        fail("test3d on the trained checkpoint is not finite")
    del model, probs
    torch.cuda.empty_cache()
    return perf, launches[TRAIN_CASES[1][0]]


# ------------------------------------------------------------ phase 7 ----

# mbconv_front cases: (label, eff-b4 block index at stem stride 1, H): the
# five shapes of the 17 blocks that the fused-eval gate admits at 288^2,
# one stride-2 block with asymmetric static pads and one expand_ratio-1
# block (both outside the gate, which the wrapper takes all the same)
MBCONV_CASES = [("H144 k3 32->192", 3, 144), ("H72 k5 56->336", 7, 72),
                ("H36 k3 112->672", 11, 36), ("H36 k5 112->672", 16, 36),
                ("H36 k5 160->960", 17, 36),
                ("stride 2 H36 k5 160->960", 22, 36),
                ("expand 1 H288 k3 48", 0, 288)]
MBCONV_BATCH = 8
# the fused bf16 backbone's error against the fp32 one, as a multiple of
# the unfused bf16 backbone's own error (endpoint_errors)
BACKBONE_ERR_RATIO = 1.5
# eff-b4 288^2 at stem stride 1: blocks the fused-eval gate admits
MBCONV_PER_FORWARD = 17
# mbconv_front's kernels in a profile (the block kernel, the SE mean pass)
MBCONV_KERNELS = ("mbconv_kernel", "se_mean_kernel")


def mbconv_inputs(torch, spec, h, dt, seed):
    """x [B, H, H, Cin] channels-last (an NHWC view of NCHW memory, as the
    blocks hold it), weights as the model gives them to the kernel, folded
    BatchNorm affines in fp32."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * s
    cin, k = spec.in_filters, spec.kernel
    cexp = cin * spec.expand_ratio
    x = rn(MBCONV_BATCH, cin, h, h).to(dt).contiguous(
        memory_format=torch.channels_last).permute(0, 2, 3, 1)
    aff = lambda: (torch.rand(cexp, generator=g, device="cuda") + 0.5,
                   rn(cexp, s=0.1))
    s0, b0 = aff()
    s1, b1 = aff()
    w_exp = (rn(cin, cexp, s=1 / math.sqrt(cin)).to(dt)
             if spec.expand_ratio != 1 else None)
    # fp32 holding compute-dtype values, the kernel's type (as the model
    # passes it)
    w_dw = rn(k, k, cexp, s=1 / k).to(dt).float()
    if w_exp is None:
        s0 = b0 = None
    return [x, w_exp, s0, b0, w_dw, s1, b1]


def mbconv_unfused(torch, F, args, spec):
    """The unfused module chain of one block's front half, as the backbone
    runs it (cuDNN 1x1 conv, folded BN, silu, padded depthwise conv, BN,
    silu, SE mean): the yardstick of tools/prof/_prof_mb.py."""
    x, w_exp, s0, b0, w_dw, s1, b1 = args
    dt = x.dtype
    cexp = w_dw.shape[-1]
    e = x.permute(0, 3, 1, 2)
    if w_exp is not None:
        e = F.conv2d(e, w_exp.t().reshape(cexp, -1, 1, 1))
        e = F.silu(e * s0.to(dt).view(-1, 1, 1) + b0.to(dt).view(-1, 1, 1))
    (pt, pb), (pl, pr) = spec.pad
    e = F.conv2d(F.pad(e, (pl, pr, pt, pb)),
                 w_dw.to(dt).permute(2, 0, 1).unsqueeze(1), stride=spec.stride,
                 groups=cexp)
    e = F.silu(e * s1.to(dt).view(-1, 1, 1) + b1.to(dt).view(-1, 1, 1))
    return e, e.mean((2, 3))


def mbconv_plan(torch, mb, spec, h, dt):
    """The plan of a case and the built kernel's shared memory and blocks
    per SM, which must agree with it."""
    cin, k, st = spec.in_filters, spec.kernel, spec.stride
    expand = spec.expand_ratio != 1
    plan = mb._mb_plan(MBCONV_BATCH, h, h, cin, cin * spec.expand_ratio, k,
                       st, spec.pad, dt, torch.cuda.get_device_properties(
                           0).multi_processor_count, expand)
    wo = mb._out_size(h, h, k, st, spec.pad)[1]
    occ = mb.mb_occupancy(plan, dt, k, st, h, cin, spec.pad[1][0], wo, expand)
    if occ["smem"] != plan.smem or occ["blocks_per_sm"] < plan.blocks_per_sm:
        fail(f"mbconv_front kernel at H={h} k={k}: built shared memory "
             f"{occ}, plan {plan}")
    return dict(rows=plan.rows, grid=list(plan.grid), run=plan.nr,
                ring=plan.ring, smem=plan.smem, waves=plan.waves,
                plan_blocks_per_sm=plan.blocks_per_sm,
                blocks_per_sm=occ["blocks_per_sm"])


def check_mbconv(torch, mb):
    """The kernel against its plain version at every case, bf16 and fp32
    (TF32 off), with CUDA-event times of the kernel, the plain version and
    the unfused module chain, each case's plan and the built kernel's
    shared memory and blocks per SM."""
    import torch.nn.functional as F
    from segtran_tpu_torch.nn.backbones.efficientnet import build_block_specs
    blocks = build_block_specs("eff-b4", 1)[0]
    results = []
    for dname, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        for i, (label, bi, h) in enumerate(MBCONV_CASES):
            spec = blocks[bi]
            kw = dict(kernel=spec.kernel, stride=spec.stride, pad=spec.pad)
            args = mbconv_inputs(torch, spec, h, dt, seed=100 + i)
            out, se = mb.mbconv_front(*args, **kw)
            ref, se_ref = mb.mbconv_front_reference(*args, **kw)
            again, se_again = mb.mbconv_front(*args, **kw)
            torch.cuda.synchronize()
            if out.shape != ref.shape or out.dtype != dt or \
                    se.shape != se_ref.shape:
                fail(f"mbconv_front {label} {dname}: got "
                     f"{tuple(out.shape)} {out.dtype}, want "
                     f"{tuple(ref.shape)}")
            err = (out.float() - ref.float()).abs()
            max_err, mean_err = float(err.max()), float(err.mean())
            rel_err = float((err / (1 + ref.float().abs())).max())
            se_err = float(((se - se_ref).abs() / (1 + se_ref.abs())).max())
            repeat = bool(torch.equal(out, again) and torch.equal(se, se_again))
            tol_max, tol_mean = KERNEL_TOL[dname]
            ms = cuda_ms(torch, lambda: mb.mbconv_front(*args, **kw), iters=10)
            plain_ms = cuda_ms(
                torch, lambda: mb.mbconv_front_reference(*args, **kw), iters=3)
            unfused_ms = cuda_ms(
                torch, lambda: mbconv_unfused(torch, F, args, spec), iters=10)
            x = args[0]
            b, hh, ww, cin = x.shape
            _, ho, wo, cexp = out.shape
            flops = 2 * b * ho * wo * spec.kernel ** 2 * cexp
            if args[1] is not None:
                flops += 2 * b * hh * ww * cin * cexp
            nbytes = sum(t.numel() * t.element_size()
                         for t in args if t is not None)
            nbytes += out.numel() * out.element_size() + se.numel() * 4
            t_ops, t_bytes = flops / PEAK_FLOPS[dname], nbytes / PEAK_BYTES
            plan = mbconv_plan(torch, mb, spec, h, dt)
            row = dict(name="mbconv_front", case=label, dtype=dname,
                       shape=[b, hh, ww, cin, cexp, spec.kernel, spec.stride],
                       plan=plan,
                       max_abs_err=max_err, mean_abs_err=mean_err,
                       max_rel_err=rel_err, se_max_rel_err=se_err,
                       ms=ms, plain_ms=plain_ms, unfused_chain_ms=unfused_ms,
                       bound_ms=max(t_ops, t_bytes) * 1e3,
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       flop=flops, bytes=nbytes, library_ms=None)
            results.append(row)
            log(f"[mbconv] {label} {dname} B={b}: max_abs_err {max_err:.3e} "
                f"max |err|/(1+|plain|) {rel_err:.3e} mean_abs_err "
                f"{mean_err:.3e}, SE mean {se_err:.3e} (tol {tol_max:g}/"
                f"{tol_mean:g}); repeatable {repeat}; kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, unfused chain {unfused_ms:.4f} ms, "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); plan "
                f"{plan}")
            if not (rel_err <= tol_max and mean_err <= tol_mean
                    and se_err <= tol_max and repeat):
                fail(f"mbconv_front {label} {dname} disagrees with its plain "
                     f"version or does not repeat")
            del args, out, ref, again
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    from segtran_tpu_torch.kernels import _build
    report = [ln.strip()
              for ln in _build.BUILD_LOG.get("mbconv", "").splitlines()
              if "registers" in ln or "spill" in ln or "Compiling" in ln]
    for ln in report or ["(built before this process: no ptxas report)"]:
        log(f"[mbconv] ptxas: {ln}")
    return results


def seeded_backbone(torch, fused, dtype=None, seed=0):
    """The eff-b4 backbone at stem stride 1 (bf16 unless given) with seeded
    weights and non-trivial BatchNorm affines and running statistics."""
    from segtran_tpu_torch.models.segtran2d import init_segtran2d
    from segtran_tpu_torch.nn.backbones.efficientnet import (
        EfficientNetFeatures, FoldedBatchNorm)
    bb = EfficientNetFeatures("eff-b4", stem_stride=1, fused_eval=fused,
                              dtype=dtype or torch.bfloat16)
    init_segtran2d(bb, seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in bb.modules():
            if isinstance(m, FoldedBatchNorm):
                n = m.weight.shape[0]
                m.weight.add_(0.1 * torch.randn(n, generator=g))
                m.bias.add_(0.1 * torch.randn(n, generator=g))
                m.running_mean.add_(0.1 * torch.randn(n, generator=g))
                m.running_var.mul_(0.5 + torch.rand(n, generator=g))
    return bb.cuda().eval()


def endpoint_errors(torch, got, truth):
    """Worst over the endpoints of (max |diff| / max |truth|, mean |diff| /
    mean |truth|)."""
    worst = (0.0, 0.0)
    for g, t in zip(got, truth):
        d, t = (g.float() - t).abs(), t.abs()
        worst = (max(worst[0], float(d.max() / t.max())),
                 max(worst[1], float(d.mean() / t.mean())))
    return worst


def backbone_fused(torch, mb):
    """The eff-b4 288^2 backbone (stem stride 1, bf16) with fused_eval on
    and off, same weights, at batch 8 and 32: 17 kernel launches per
    forward, ms per forward for each. The two bf16 paths round at other
    points (the unfused chain rounds the expand, each BatchNorm op and each
    swish to bf16; the kernel keeps them in fp32), so each is held against
    the fp32 unfused backbone: the fused path's error must stay within
    BACKBONE_ERR_RATIO of the unfused path's own bf16 error, and within
    MODEL_TOL of the unfused path."""
    fused, plain = seeded_backbone(torch, True), seeded_backbone(torch, False)
    exact = seeded_backbone(torch, False, torch.float32)
    if {k: v.shape for k, v in fused.state_dict().items()} != {
            k: v.shape for k, v in plain.state_dict().items()}:
        fail("fused_eval changed the backbone's state_dict")
    torch.backends.cudnn.allow_tf32 = False
    perf, launches = {}, {}
    for b in (8, 32):
        g = torch.Generator(device="cuda").manual_seed(b)
        x = torch.randn(b, 288, 288, 3, generator=g, device="cuda")
        with torch.inference_mode():
            mb.reset_launches()
            got = fused(x)
            torch.cuda.synchronize()
            launches[b] = mb.mbconv_front.launches
            truth = [t.float() for t in exact(x)]
            unfused = plain(x)
            e_f = endpoint_errors(torch, got, truth)
            e_u = endpoint_errors(torch, unfused, truth)
            e_fu = endpoint_errors(torch, got, [u.float() for u in unfused])
            finite = all(bool(torch.isfinite(f).all()) for f in got)
            del got, truth, unfused
            ms_f = cuda_ms(torch, lambda: fused(x), iters=5)
            ms_u = cuda_ms(torch, lambda: plain(x), iters=5)
            prof = {name: profile_forward(
                torch, lambda m=m: (m(x), torch.cuda.synchronize()),
                f"eff-b4 288^2 backbone B={b} bf16 {name}",
                {"mbconv_front": MBCONV_KERNELS})
                for name, m in (("fused", fused), ("unfused", plain))}
        log(f"[mbconv] eff-b4 288^2 backbone B={b} bf16: {launches[b]} "
            f"mbconv_front launches per forward (want "
            f"{MBCONV_PER_FORWARD}); endpoints against the fp32 backbone "
            f"(max |diff|/max, mean |diff|/mean): fused {e_f[0]:.3e} "
            f"{e_f[1]:.3e}, unfused {e_u[0]:.3e} {e_u[1]:.3e} (ratio tol "
            f"{BACKBONE_ERR_RATIO:g}); fused against unfused {e_fu[0]:.3e} "
            f"{e_fu[1]:.3e} (tol {MODEL_TOL[0]:g}/{MODEL_TOL[1]:g}); fused "
            f"{ms_f:.3f} ms, unfused {ms_u:.3f} ms per forward")
        if launches[b] != MBCONV_PER_FORWARD:
            fail(f"the fused backbone launched mbconv_front {launches[b]} "
                 f"times")
        if not finite or e_f[0] > BACKBONE_ERR_RATIO * e_u[0] \
                or e_f[1] > BACKBONE_ERR_RATIO * e_u[1]:
            fail("the fused backbone is further from the fp32 backbone "
                 "than the unfused bf16 one")
        if e_fu[0] > MODEL_TOL[0] or e_fu[1] > MODEL_TOL[1]:
            fail("the fused backbone disagrees with the unfused one")
        perf[f"bs{b}"] = dict(fused_ms=ms_f, unfused_ms=ms_u,
                              fused_err_vs_fp32=e_f, unfused_err_vs_fp32=e_u,
                              fused_vs_unfused=e_fu, profile=prof)
        del x
    torch.backends.cudnn.allow_tf32 = True
    del fused, plain, exact
    torch.cuda.empty_cache()
    return perf, launches[8]


# the fundus Segtran2d train step (bench.py's bench_fundus_train): eff-b4,
# 3 classes, 3 translayers 1792->1792->896->448, 256 attractors, bf16,
# dropout 0.1, BCE (0, 1, 2) + Dice 0.5, BertAdam with the recipe defaults
# and the global clip 0.1; (batch, remat_blocks) as bench's two lines
FUNDUS_TRAIN_CASES = [(6, True), (24, False)]
FUNDUS_SIZE = 288
# fp32 remat on vs off: the loss and the running statistics come from the
# same forward (equal to rounding); gradients as max |diff| / max |off|,
# within 1e-2 or within REMAT_FLOOR times the spread of two runs of the
# step without remat (the bilinear resizes' backward adds with atomics, so
# a gradient that the train-mode BatchNorms nearly cancel differs from run
# to run)
REMAT_TOL = {"loss_rel": 1e-6, "stats": 1e-6, "grad": 1e-2}
REMAT_FLOOR = 3.0
REMAT_NOISE = 1e-6


def fundus_config(torch, dtype, remat_blocks):
    from segtran_tpu_torch.configs.base import Segtran2dConfig
    cfg = Segtran2dConfig(backbone_type="eff-b4", num_classes=3, dtype=dtype,
                          remat_blocks=remat_blocks).derive(
                              translayer_compress_ratios=(1.0, 1.0, 2.0, 2.0))
    if (cfg.translayer_dims != (1792, 1792, 896, 448)
            or cfg.num_attractors != 256 or cfg.num_modes != 4
            or cfg.hidden_dropout_prob != 0.1):
        fail(f"unexpected fundus training config {cfg}")
    return cfg


def fundus_batch(torch, bs, seed):
    """Synthetic 288^2 images and one-hot 3-class masks, made on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    image = torch.randn(bs, FUNDUS_SIZE, FUNDUS_SIZE, 3, generator=g,
                        device="cuda")
    cls = torch.randint(0, 3, (bs, FUNDUS_SIZE, FUNDUS_SIZE), generator=g,
                        device="cuda")
    return {"image": image,
            "mask": torch.nn.functional.one_hot(cls, 3).float()}


def fundus_model(torch, cfg, seed=0):
    from segtran_tpu_torch.models.segtran2d import Segtran2d
    from segtran_tpu_torch.nn.attention import set_dropout_generator
    from segtran_tpu_torch.nn.init import init_with_reference_schemes
    model = init_with_reference_schemes(Segtran2d(cfg), cfg, seed).cuda()
    set_dropout_generator(model, torch.Generator(device="cuda").manual_seed(
        seed))
    return model


def fundus_remat_check(torch):
    """One fp32 forward + backward (TF32 off) of the full-width model at
    batch 2 with remat_blocks on, and twice with it off, same weights and
    generator: equal loss, running statistics updated once, gradients
    within REMAT_TOL or REMAT_FLOOR times the two plain runs' spread."""
    from segtran_tpu_torch.train.trainer import make_loss_fn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = fundus_batch(torch, 2, seed=5)
    loss_fn = make_loss_fn(3, (0.0, 1.0, 2.0))
    runs = []
    for remat_blocks in (True, False, False):
        model = fundus_model(torch, fundus_config(torch, torch.float32,
                                                  remat_blocks))
        loss, _ = loss_fn(model.train()(batch["image"]), batch["mask"])
        loss.backward()
        runs.append((
            float(loss.detach()),
            {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None},
            {n: b for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}))
        del model, loss
    torch.backends.cudnn.allow_tf32 = True
    (l_on, g_on, s_on), (l_off, g_off, s_off), (_, g_again, _) = runs
    loss_rel = abs(l_on - l_off) / abs(l_off)
    # a gradient whose largest entry lies below REMAT_NOISE of the model's
    # largest is zero by structure (the mode softmax's shared shift):
    # rounding noise, held against the model's largest gradient instead
    g_max = max(float(g.abs().max()) for g in g_off.values())

    def rel(grads, n):
        g = g_off[n]
        return float((grads[n] - g).abs().max()) / max(
            float(g.abs().max()), REMAT_NOISE * g_max)

    w_on = max((rel(g_on, n), n) for n in g_off)
    w_floor = max((rel(g_again, n), n) for n in g_off)
    grad_tol = max(REMAT_TOL["grad"], REMAT_FLOOR * w_floor[0])
    stats = max(float((s_on[n] - v).abs().max() / (1 + v.abs().max()))
                for n, v in s_off.items())
    log(f"[fundus_train] fp32 remat_blocks on vs off at batch 2: loss "
        f"{l_on:.7f} vs {l_off:.7f} (rel {loss_rel:.2e}); worst gradient "
        f"max |diff| / max |off| {w_on[0]:.2e} ({w_on[1]}) over "
        f"{len(g_off)} tensors (two runs without remat: "
        f"{rel(g_again, w_on[1]):.2e} there), two runs without remat "
        f"{w_floor[0]:.2e} ({w_floor[1]}), tol {grad_tol:.2e}; running "
        f"statistics max |diff|"
        f" / (1 + max) {stats:.2e} over {len(s_off)} (tol "
        f"{REMAT_TOL['stats']:g})")
    if set(g_on) != set(g_off) or set(s_on) != set(s_off):
        fail("remat_blocks changed the set of gradients or statistics")
    if (loss_rel > REMAT_TOL["loss_rel"] or w_on[0] > grad_tol
            or stats > REMAT_TOL["stats"]):
        fail("the fp32 step with remat_blocks disagrees with the step "
             "without it")
    return dict(fp32_remat_loss_rel=loss_rel, fp32_remat_worst_grad=w_on[0],
                fp32_remat_worst_grad_tensor=w_on[1],
                fp32_plain_rerun_worst_grad=w_floor[0],
                fp32_remat_stats_diff=stats)


def fundus_training(torch):
    """The fundus train step at full width through make_train_step: bs 6
    with remat_blocks, bs 24 without; ms per step (host clock around 3
    steps after a warm one, ending in a synchronise), peak memory, one
    profiled step; then the fp32 remat check."""
    from segtran_tpu_torch.train.trainer import (build_optimizer,
                                                 make_loss_fn,
                                                 make_train_step)
    perf = {}
    for bs, remat_blocks in FUNDUS_TRAIN_CASES:
        label = f"bs{bs} remat_blocks {'on' if remat_blocks else 'off'}"
        model = fundus_model(torch, fundus_config(torch, torch.bfloat16,
                                                  remat_blocks))
        opt = build_optimizer(model)
        step = make_train_step(model, opt, make_loss_fn(3, (0.0, 1.0, 2.0)),
                               grad_clip=0.1)
        batch = fundus_batch(torch, bs, seed=bs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            step(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = [step(batch)["loss"] for _ in range(3)]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / 3 * 1e3
        except torch.cuda.OutOfMemoryError:
            peak = torch.cuda.max_memory_allocated() / 1e9
            log(f"[fundus_train] {label}: out of memory on the 80 GB card "
                f"at a peak of {peak:.2f} GB allocated")
            perf[label] = dict(out_of_memory=True, peak_mem_gb=peak)
            del model, opt, step, batch
            torch.cuda.empty_cache()
            continue
        peak = torch.cuda.max_memory_allocated() / 1e9
        finite = all(bool(torch.isfinite(v)) for v in losses) and all(
            p.grad is None or bool(torch.isfinite(p.grad).all())
            for p in model.parameters())
        row = dict(ms_per_step=ms, imgs_per_s=bs * 1e3 / ms,
                   peak_mem_gb=peak, loss=[float(v) for v in losses],
                   finite=finite)
        row.update(profile_forward(
            torch, lambda: (step(batch), torch.cuda.synchronize()),
            f"one fundus train step {label}",
            {"conv fprop": "fprop", "conv dgrad": "dgrad",
             "conv wgrad": "wgrad", "depthwise": "depthwise",
             "gemm": "gemm", "elementwise": "elementwise",
             "reductions": "reduce_kernel", "batch norm": "batch_norm",
             "resizes": "upsample_bilinear"}))
        log(f"[fundus_train] {label}: {ms:.2f} ms per step "
            f"({row['imgs_per_s']:.1f} images/s), peak {peak:.2f} GB, "
            f"losses {row['loss']}, finite {finite}")
        if not finite:
            fail(f"fundus train step {label}: a loss or gradient is not "
                 f"finite")
        perf[label] = row
        del model, opt, step, batch
        torch.cuda.empty_cache()
    perf.update(fundus_remat_check(torch))
    torch.cuda.empty_cache()
    return perf


# ------------------------------------------------------------ phase 8 ----

FUNDUS_CLI_ARGV = ["--task", "fundus", "--bb", "eff-b4", "--translayers", "3",
                   "--layercompress", "1,1,2,2", "--attractors", "256",
                   "--bf16", "--device", "cuda"]
CLI_TRAIN_FRAMES, CLI_EVAL_FRAMES, CLI_STEPS, CLI_BS = 24, 8, 6, 6
# the augmentation on the card against the same draws on the CPU: images
# in fp32 (bilinear resizes and mean reductions sum in other orders),
# masks exactly (index gathers)
AUG_TOL = 1e-5
DICE_TOL = 0.01


def synthetic_fundus(np, n, seed, size=576):
    """n REFUGE-like frames held in memory: a dark fundus with a bright
    optic disc and a brighter cup as nested ellipses; raw masks 255
    background, 128 disc, 0 cup (the card's machine has no Pillow to read
    PNG files). Samples follow data/datasets2d.py's schema."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:size, :size].astype(np.float32)
    frames = []
    for i in range(n):
        cy, cx = rng.uniform(0.35, 0.65, 2) * size
        ry, rx = rng.uniform(0.12, 0.22, 2) * size
        r = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
        cup = rng.uniform(0.15, 0.45)
        mask = np.full((size, size), 255, np.uint8)
        mask[r < 1] = 128
        mask[r < cup] = 0
        base = rng.uniform(0.2, 0.5, 3).astype(np.float32)
        image = (base + 0.3 * (r < 1)[..., None] + 0.2 * (r < cup)[..., None]
                 + 0.05 * rng.randn(size, size, 3)).clip(0, 1)
        frames.append({
            "image": image.astype(np.float32), "mask": mask[..., None],
            "index": i, "crop_pos": np.array([0, 0]),
            "unscaled_size": np.array([size, size]),
            "uncropped_size": np.asarray((2056, 2124))})

    class Frames(list):
        image_list = [f"synthetic{i:03d}.png" for i in range(n)]
    return Frames(frames)


def cli_augment_check(torch, train2d, step, args, task, frames):
    """step.augment on the card against the same draws on CPU tensors."""
    import numpy as np
    from segtran_tpu_torch.data.augment import draw_2d
    batch = {k: torch.from_numpy(np.stack([f[k] for f in frames[:CLI_BS]]))
             for k in ("image", "mask")}
    stand_in = torch.nn.Linear(1, 1)      # augment touches no model
    cpu_step = train2d.make_step(stand_in, torch.optim.SGD(
        stand_in.parameters(), lr=0.0), args, task, torch.device("cpu"))
    mean, std = train2d.load_stats(args, "train")
    cfg = train2d.aug_config(args, mean, std)
    draws = draw_2d(CLI_BS, cfg, torch.Generator(device="cuda").manual_seed(7))
    on_card = step.augment({k: v.cuda() for k, v in batch.items()}, draws)
    on_cpu = cpu_step.augment(batch, {k: v.cpu() for k, v in draws.items()})
    img_err = float((on_card["image"].cpu() - on_cpu["image"]).abs().max())
    mask_same = bool(torch.equal(on_card["mask"].cpu(), on_cpu["mask"]))
    turned = int((draws["rot_k"] > 0).sum())
    log(f"[fundus_cli] step.augment on the card vs the CPU, same draws "
        f"({turned} of {CLI_BS} turned, {int(draws['crop_pad'].sum())} "
        f"zoomed): images max |err| {img_err:.3e} (tol {AUG_TOL:g}), masks "
        f"{'equal' if mask_same else 'DIFFER'}")
    if img_err > AUG_TOL or not mask_same:
        fail("the augmentation on the card disagrees with the CPU")
    return dict(aug_card_vs_cpu_max_abs=img_err)


def cli_step_perf(torch, train2d, model, args, task, frames):
    """The CLI step (label map, augmentation, resize, train step) at bs 6
    on a fixed batch: ms per step on the host clock (3 steps after a warm
    one, ending in a synchronise), peak memory; profiled device time of
    one step and of its augmentation alone (their ratio: the augmentation
    share); make_train_step alone on the augmented batch, on the same
    model and optimizer, timed the same way. Returns (numbers, step)."""
    import numpy as np
    from segtran_tpu_torch.train.trainer import (build_optimizer,
                                                 make_loss_fn,
                                                 make_train_step)
    dev = torch.device("cuda")
    opt = build_optimizer(model, lr=2e-4, decay=1e-4, t_total=100,
                          warmup_ratio=0.05)
    step = train2d.make_step(model, opt, args, task, dev)
    batch = {k: torch.from_numpy(np.stack([f[k] for f in frames[:CLI_BS]]))
             .to(dev) for k in ("image", "mask")}

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = [fn() for _ in range(3)]
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 3 * 1e3, out

    torch.cuda.reset_peak_memory_stats()
    ms, outs = timed(lambda: step(batch))
    peak = torch.cuda.max_memory_allocated() / 1e9
    finite = all(bool(torch.isfinite(m["loss"])) for m in outs)
    aug_ms, _ = timed(lambda: step.augment(batch))
    base = make_train_step(model, opt, make_loss_fn(
        3, task["bce_weight"], dice_w=args.max_dice_w), grad_clip=0.1)
    augmented = step.augment(batch)
    base_ms, _ = timed(lambda: base(augmented))
    prof_step = profile_forward(
        torch, lambda: (step(batch), torch.cuda.synchronize()),
        "one train2d CLI step bs6", {"index gathers": "index",
                                     "resizes": "upsample_bilinear"})
    prof_aug = profile_forward(
        torch, lambda: (step.augment(batch), torch.cuda.synchronize()),
        "its label map + augmentation + resize alone",
        {"index gathers": "index"})
    share = (prof_aug.get("profile_device_busy_ms", 0.0)
             / max(prof_step.get("profile_device_busy_ms", 0.0), 1e-9))
    log(f"[fundus_cli] train2d step bs{CLI_BS}: {ms:.2f} ms per step, "
        f"peak {peak:.2f} GB, losses {[float(m['loss']) for m in outs]}; "
        f"label map + augmentation + resize {aug_ms:.2f} ms alone on the "
        f"host clock, {100 * share:.1f}% of the step's device time; "
        f"make_train_step alone on the augmented batch {base_ms:.2f} ms")
    if not finite:
        fail("a train2d step's loss is not finite")
    return dict(ms_per_step=ms, peak_mem_gb=peak, augment_ms=aug_ms,
                augment_device_share=share, make_train_step_ms=base_ms,
                step_profile=prof_step, augment_profile=prof_aug), step


def cli_eval(torch, test2d, ckpt, frames, extra, epi, sa, logger):
    """test2d.evaluate_checkpoint at the flagship on iter_6.pt with the
    given flags: (per-class Dice + vCDR error, probabilities, launches,
    seconds per frame of a second call)."""
    import numpy as np
    from segtran_tpu_torch.infer.sliding import sliding_window_2d
    from segtran_tpu_torch.train.checkpoint import load_checkpoint
    from segtran_tpu_torch.cli import train2d
    args = test2d.build_argparser().parse_args(
        FUNDUS_CLI_ARGV + ["--cpdir", ckpt, "--iters", str(CLI_STEPS),
                           "--bs", str(CLI_EVAL_FRAMES), "--vcdr"] + extra)
    task = train2d.task_settings(args)
    model, cfg = test2d.build_model(args, task)
    model.load_state_dict(load_checkpoint(os.path.join(
        ckpt, f"iter_{CLI_STEPS}"), cfg), strict=True)
    model = model.cuda().eval()
    mean, std = train2d.load_stats(args, "train")
    dev = torch.device("cuda")
    epi.reset_launches()
    sa.reset_launches()
    result = test2d.evaluate_checkpoint(model, frames, task, args, logger,
                                        mean, std, dev)
    launches = {fn.__name__: fn.launches for fn in (
        epi.fused_mid_output_pool_permode, epi.fused_mid_output_pool,
        epi.fused_private_output_pool, sa.fused_cross_attention)}
    t0 = time.perf_counter()
    test2d.evaluate_checkpoint(model, frames, task, args, logger, mean, std,
                               dev)
    s_per_frame = (time.perf_counter() - t0) / len(frames)
    fn = test2d.make_model_fn(model, mean, std, args.gray_alpha, dev)
    x = torch.from_numpy(np.stack([f["image"] for f in frames])).to(dev)
    with torch.inference_mode():
        probs = sliding_window_2d(fn, x, tuple(task["orig_input_size"]),
                                  tuple(task["patch_size"]),
                                  num_classes=3).cpu().numpy()
    del model
    torch.cuda.empty_cache()
    return result, probs, launches, s_per_frame


def fundus_cli(torch, np, epi, sa, ckdir, logger, make_train_step_ms=None):
    """Phase 8: train2d.train() at the flagship's full width on synthetic
    in-memory frames (bs 6, 6 steps, iter_6.pt), the CLI step's cost, the
    augmentation on the card against the CPU, then test2d's
    evaluate_checkpoint on the checkpoint with --fusedepi, with the
    unfused modules and with --fused --fusedepi."""
    from segtran_tpu_torch.cli import test2d, train2d
    from segtran_tpu_torch.nn.init import init_with_reference_schemes
    dev = torch.device("cuda")
    frames = synthetic_fundus(np, CLI_TRAIN_FRAMES, seed=0)
    args = train2d.build_argparser().parse_args(
        FUNDUS_CLI_ARGV + ["--seed", "0", "--bs", str(CLI_BS),
                           "--maxiter", str(CLI_STEPS),
                           "--saveiter", str(CLI_STEPS), "--logiter", "1",
                           "--ckptdir", ckdir])
    task = train2d.task_settings(args)
    model, cfg = train2d.build_model_and_config(args, task)
    if (cfg.translayer_dims != (1792, 1792, 896, 448) or cfg.num_modes != 4
            or cfg.num_attractors != 256 or cfg.dtype != torch.bfloat16
            or not cfg.remat_blocks or cfg.pos_code_type != "lsinu"):
        fail(f"unexpected train2d flagship config {cfg}")
    init_with_reference_schemes(model, cfg, seed=0)
    model = model.to(dev)
    epi.reset_launches()
    sa.reset_launches()
    t0 = time.perf_counter()
    ckpt = train2d.train(model, frames, args, task, dev, cfg,
                         os.path.join(ckdir, "fundus_cli"), logger)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trained = os.path.join(ckpt, f"iter_{CLI_STEPS}.pt")
    finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    log(f"[fundus_cli] train2d.train(): {CLI_STEPS} steps at bs {CLI_BS} in "
        f"{wall:.2f} s (first step included); wrote {trained}: "
        f"{os.path.isfile(trained)}; parameters finite {finite}")
    if not os.path.isfile(trained) or not finite:
        fail("train2d.train() did not write a finite iter_6 checkpoint")
    perf = dict(train_wall_s=wall)
    step_perf, step = cli_step_perf(torch, train2d, model, args, task,
                                    frames)
    perf.update(step_perf)
    perf["phase7_make_train_step_bs6_ms"] = make_train_step_ms
    log(f"[fundus_cli] phase 7's make_train_step bs6 (remat_blocks on, "
        f"synthetic one-hot masks at 288^2): "
        + (f"{make_train_step_ms:.2f} ms" if make_train_step_ms
           else "not run in this call"))
    perf.update(cli_augment_check(torch, train2d, step, args, task, frames))
    del model, step
    torch.cuda.empty_cache()

    eval_frames = synthetic_fundus(np, CLI_EVAL_FRAMES, seed=1)
    runs = {}
    for label, extra in (("fusedepi", ["--fusedepi"]), ("unfused", []),
                         ("fused", ["--fused", "--fusedepi"])):
        runs[label] = cli_eval(torch, test2d, ckpt, eval_frames, extra, epi,
                               sa, logger)
        res, _, launches, spf = runs[label]
        log(f"[fundus_cli] test2d {label}: per-class Dice "
            f"{[round(float(d), 4) for d in res[:2]]}, vCDR error "
            f"{float(res[2]):.4f}; {spf:.4f} s per 576^2 frame; launches "
            f"{json.dumps(launches)}")
        perf[f"eval_{label}_s_per_frame"] = spf
        perf[f"eval_{label}_dice"] = [float(d) for d in res[:2]]
        perf[f"eval_{label}_vcdr_err"] = float(res[2])
        perf[f"eval_{label}_launches"] = launches
    want = {"fusedepi": (1, 2, 0, 0), "unfused": (0, 0, 0, 0),
            "fused": (0, 0, 3, 6)}
    for label, counts in want.items():
        got = tuple(runs[label][2].values())
        if got != counts:
            fail(f"test2d {label}: launches (per-mode, all-modes, private, "
                 f"flash) {got}, want {counts} for one batch forward")
    ref_res, ref_probs = runs["unfused"][0], runs["unfused"][1]
    for label in ("fusedepi", "fused"):
        res, probs = runs[label][0], runs[label][1]
        mx, mean = compare(probs, ref_probs)
        ddice = float(np.abs(res[:2] - ref_res[:2]).max())
        perf[f"eval_{label}_vs_unfused"] = dict(max_abs=mx, mean_abs=mean,
                                                dice=ddice)
        log(f"[fundus_cli] test2d {label} vs unfused: probabilities max "
            f"{mx:.3e} mean {mean:.3e} (tol {MODEL_TOL[0]:g}/"
            f"{MODEL_TOL[1]:g}); per-class Dice max |diff| {ddice:.4f} "
            f"(tol {DICE_TOL:g})")
        if not (mx <= MODEL_TOL[0] and mean <= MODEL_TOL[1]
                and ddice <= DICE_TOL):
            fail(f"test2d {label} disagrees with the unfused modules")
        if not np.isfinite(res).all():
            fail(f"test2d {label}: Dice or vCDR not finite")
    return perf


# ------------------------------------------------------------ phase 9 ----

# the private tier's shapes on the non-squeezed --fused --fusedepi path (mid
# [8,4,1296,F], F = 1792, 896, 448): indices into EPILOGUE_CASES
PRIVATE_NOSQUEEZE_CASES = (8, 9, 10)
OPTIONS_ARGV = ["--task", "fundus", "--bb", "eff-b4", "--translayers", "3",
                "--layercompress", "1,1,2,2", "--attractors", "256",
                "--bf16", "--device", "cuda"]
# (label, flags, launches (flash forward, private tier, full tier) of one
# batch-8 forward with --fused --fusedepi): the gate keeps the flash kernel
# off the position biases and --multihead, the route the epilogue off the
# shared output, --multihead and the global bias (no encoder)
OPTION_CASES = [
    ("nosqueeze", ["--nosqueeze"], (3, 3, 0)),
    ("nosqueeze pos bias", ["--nosqueeze", "--pos", "bias"], (0, 3, 0)),
    ("pos rand", ["--pos", "rand"], (6, 3, 0)),
    ("pos sinu", ["--pos", "sinu"], (6, 3, 0)),
    ("multihead", ["--multihead"], (0, 0, 0)),
    ("inbn", ["--inbn"], (6, 3, 0)),
    ("gbias", ["--gbias"], (0, 0, 0)),
    ("no out-FPN", ["--outfpn", "34"], (6, 3, 0)),
    ("shared output", [], (6, 0, 0))]
OPTION_BS, OCT_FRAMES, OPTION_TRAIN_BS, PREP_FRAMES = 8, 8, 6, 2


def option_launches(epi, sa):
    return (sa.fused_cross_attention.launches,
            epi.fused_private_output_pool.launches,
            epi.fused_mid_output_pool.launches
            + epi.fused_mid_output_pool_permode.launches)


def option_models(torch, test2d, train2d, flags, shared_output, seed):
    """(fused model, unfused model) with the same seeded weights, built by
    test2d's factory with --fused --fusedepi and without."""
    import dataclasses
    from segtran_tpu_torch.models.segtran2d import Segtran2d
    from segtran_tpu_torch.nn.init import init_with_reference_schemes
    models = []
    for fused in (True, False):
        args = test2d.build_argparser().parse_args(
            OPTIONS_ARGV + flags + ["--cpdir", "unused"]
            + (["--fused", "--fusedepi"] if fused else []))
        task = train2d.task_settings(args)
        model, cfg = test2d.build_model(args, task)
        if shared_output:
            # trans_output_type has no flag (the JAX CLIs set none either)
            cfg = dataclasses.replace(cfg, trans_output_type="shared")
            model = Segtran2d(cfg, patch_size=task["patch_size"])
        if fused:
            init_with_reference_schemes(model, cfg, seed)
            state = model.state_dict()
        else:
            model.load_state_dict(state, strict=True)
        models.append(model.cuda().eval())
    return models


def fundus_option_forwards(torch, np, epi, sa):
    """(a)-(c): each option at the flagship's width, a padded batch of 8
    288^2 frames, --fused --fusedepi against the unfused modules."""
    from segtran_tpu_torch.cli import test2d, train2d
    x = fundus_batch(torch, OPTION_BS, seed=9)["image"]
    perf = {}
    for i, (label, flags, want) in enumerate(OPTION_CASES):
        fused, unfused = option_models(torch, test2d, train2d, flags,
                                       label == "shared output", seed=i)
        epi.reset_launches()
        sa.reset_launches()
        with torch.inference_mode():
            got = fused(x)
            torch.cuda.synchronize()
            launches = option_launches(epi, sa)
            ref = unfused(x)
            probs = torch.sigmoid(got.float()).cpu().numpy()
            ref_probs = torch.sigmoid(ref.float()).cpu().numpy()
            ms = cuda_ms(torch, lambda: fused(x), iters=3)
            unfused_ms = cuda_ms(torch, lambda: unfused(x), iters=3)
        mx, mean = compare(probs, ref_probs)
        finite = bool(np.isfinite(probs).all())
        log(f"[fundus_options] {label}: launches (flash, private, full "
            f"tier) {launches} (want {want}); probabilities vs the unfused "
            f"modules max {mx:.3e} mean {mean:.3e} (tol {MODEL_TOL[0]:g}/"
            f"{MODEL_TOL[1]:g}); batch-{OPTION_BS} forward {ms:.2f} ms, "
            f"unfused {unfused_ms:.2f} ms")
        perf[label] = dict(launches=list(launches), max_abs=mx,
                           mean_abs=mean, ms=ms, unfused_ms=unfused_ms)
        if launches != want:
            fail(f"fundus option {label}: launches {launches}, want {want}")
        if not (finite and mx <= MODEL_TOL[0] and mean <= MODEL_TOL[1]):
            fail(f"fundus option {label} disagrees with its unfused forward")
        del fused, unfused
        torch.cuda.empty_cache()
    return perf


def synthetic_oct(np, n, seed, h=288, w=512):
    """n OCT-like B-scans held in memory: 10 wavy horizontal layers, each
    its own intensity, and their index masks (0..9); samples follow
    data/datasets2d.py's schema."""
    rng = np.random.RandomState(seed)
    xx = np.arange(w, dtype=np.float32)
    frames = []
    for i in range(n):
        bounds = np.sort(rng.uniform(0.1, 0.9, 9)) * h
        wave = 6 * np.sin(xx / rng.uniform(30, 80) + rng.uniform(0, 6))
        rows = np.arange(h, dtype=np.float32)[:, None]
        mask = sum((rows > b + wave[None]).astype(np.uint8)
                   for b in bounds)
        level = rng.uniform(0.1, 0.9, 10).astype(np.float32)
        image = (level[mask][..., None].repeat(3, -1)
                 + 0.05 * rng.randn(h, w, 3)).clip(0, 1)
        frames.append({
            "image": image.astype(np.float32),
            "mask": mask.astype(np.uint8)[..., None], "index": i,
            "crop_pos": np.array([0, 0]), "unscaled_size": np.array([h, w]),
            "uncropped_size": np.array([-1, -1])})

    class Frames(list):
        image_list = [f"oct{i:03d}.png" for i in range(n)]
    return Frames(frames)


def oct_eval(torch, np, epi, sa, ckdir, logger):
    """(d): test2d.evaluate_checkpoint on --task oct (288x512 frames, one
    window each) from a seeded checkpoint, with --fused --fusedepi (6
    flash + 3 private-tier launches per batch forward) and with the
    unfused modules: probabilities within MODEL_TOL, Dice within
    DICE_TOL."""
    from segtran_tpu_torch.cli import test2d, train2d
    from segtran_tpu_torch.infer.sliding import sliding_window_2d
    from segtran_tpu_torch.nn.init import init_with_reference_schemes
    from segtran_tpu_torch.train.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
    base = ["--task", "oct", "--bb", "eff-b4", "--translayers", "3",
            "--layercompress", "1,1,2,2", "--attractors", "256", "--bf16",
            "--device", "cuda", "--cpdir", os.path.join(ckdir, "oct"),
            "--iters", "1", "--bs", str(OCT_FRAMES)]
    frames = synthetic_oct(np, OCT_FRAMES, seed=3)
    dev = torch.device("cuda")
    runs, perf = {}, {}
    for label, extra in (("fused", ["--fused", "--fusedepi"]),
                         ("unfused", [])):
        args = test2d.build_argparser().parse_args(base + extra)
        task = train2d.task_settings(args)
        model, cfg = test2d.build_model(args, task)
        if label == "fused":
            if cfg.num_classes != 10 or tuple(task["patch_size"]) != (288,
                                                                      512):
                fail(f"unexpected oct config {cfg} / {task}")
            init_with_reference_schemes(model, cfg, seed=5)
            save_checkpoint(args.cpdir, 1, model.state_dict(), cfg)
        model.load_state_dict(load_checkpoint(
            os.path.join(args.cpdir, "iter_1"), cfg), strict=True)
        model = model.to(dev).eval()
        mean, std = train2d.load_stats(args, "duke")
        epi.reset_launches()
        sa.reset_launches()
        dice = test2d.evaluate_checkpoint(model, frames, task, args, logger,
                                          mean, std, dev)
        launches = option_launches(epi, sa)
        t0 = time.perf_counter()
        test2d.evaluate_checkpoint(model, frames, task, args, logger, mean,
                                   std, dev)
        s_per_frame = (time.perf_counter() - t0) / len(frames)
        fn = test2d.make_model_fn(model, mean, std, args.gray_alpha, dev)
        x = torch.from_numpy(np.stack([f["image"] for f in frames])).to(dev)
        with torch.inference_mode():
            probs = sliding_window_2d(fn, x, (288, 512), (288, 512),
                                      num_classes=10).cpu().numpy()
        runs[label] = (dice, probs)
        log(f"[fundus_options] oct test2d {label}: per-class Dice "
            f"{[round(float(d), 4) for d in dice]}; {s_per_frame:.4f} s per "
            f"288x512 frame; launches (flash, private, full tier) "
            f"{launches}")
        perf[f"oct_{label}"] = dict(dice=[float(d) for d in dice],
                                    s_per_frame=s_per_frame,
                                    launches=list(launches))
        if label == "fused" and launches != (6, 3, 0):
            fail(f"oct test2d --fused --fusedepi: launches {launches}, "
                 f"want (6, 3, 0)")
        del model
        torch.cuda.empty_cache()
    mx, mean = compare(runs["fused"][1], runs["unfused"][1])
    ddice = float(np.abs(runs["fused"][0] - runs["unfused"][0]).max())
    perf["oct_fused_vs_unfused"] = dict(max_abs=mx, mean_abs=mean, dice=ddice)
    log(f"[fundus_options] oct fused vs unfused: probabilities max {mx:.3e} "
        f"mean {mean:.3e}; per-class Dice max |diff| {ddice:.4f}")
    if not (mx <= MODEL_TOL[0] and mean <= MODEL_TOL[1]
            and ddice <= DICE_TOL and np.isfinite(runs["fused"][0]).all()):
        fail("oct test2d --fused --fusedepi disagrees with the unfused "
             "modules")
    return perf


def option_training(torch, np, ckdir, logger):
    """(e): two train2d.train() steps at bs 6 with --nosqueeze --pos bias
    --inbn on synthetic 576^2 frames; then the CLI step's ms per step (two
    more, host clock, ending in a synchronise) and peak memory."""
    from segtran_tpu_torch.cli import train2d
    from segtran_tpu_torch.nn.init import init_with_reference_schemes
    dev = torch.device("cuda")
    frames = synthetic_fundus(np, 2 * OPTION_TRAIN_BS, seed=4)
    args = train2d.build_argparser().parse_args(
        OPTIONS_ARGV + ["--nosqueeze", "--pos", "bias", "--inbn", "--seed",
                        "0", "--bs", str(OPTION_TRAIN_BS), "--maxiter", "2",
                        "--saveiter", "2", "--logiter", "1", "--ckptdir",
                        ckdir])
    task = train2d.task_settings(args)
    model, cfg = train2d.build_model_and_config(args, task)
    if (cfg.use_squeezed_transformer or cfg.pos_code_type != "bias"
            or not cfg.in_fpn_use_bn):
        fail(f"unexpected option training config {cfg}")
    init_with_reference_schemes(model, cfg, seed=0)
    model = model.to(dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ckpt = train2d.train(model, frames, args, task, dev, cfg,
                         os.path.join(ckdir, "options"), logger)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    from segtran_tpu_torch.train.trainer import build_optimizer
    opt = build_optimizer(model, lr=2e-4, decay=1e-4, t_total=100,
                          warmup_ratio=0.05)
    step = train2d.make_step(model, opt, args, task, dev)
    batch = {k: torch.from_numpy(np.stack([f[k] for f in frames[
        :OPTION_TRAIN_BS]])).to(dev) for k in ("image", "mask")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(step(batch)["loss"]) for _ in range(2)]
    ms = (time.perf_counter() - t0) / 2 * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    biases = model.voxel_fusion.pos_code_layer.pos_coder.biases
    moved = float(biases.detach().abs().max())
    wrote = os.path.isfile(os.path.join(ckpt, "iter_2.pt"))
    log(f"[fundus_options] train2d.train() --nosqueeze --pos bias --inbn: 2 "
        f"steps at bs {OPTION_TRAIN_BS} in {wall:.2f} s (first step "
        f"included), iter_2.pt written {wrote}; the CLI step {ms:.1f} ms "
        f"per step on the host clock (losses {losses}), peak {peak:.2f} GB; "
        f"the position biases moved off zero by {moved:.3e}")
    if not (wrote and all(math.isfinite(v) for v in losses) and moved > 0):
        fail("the --nosqueeze --pos bias --inbn train steps did not train")
    del model, step, opt
    torch.cuda.empty_cache()
    return dict(train_wall_s=wall, ms_per_step=ms, peak_mem_gb=peak,
                losses=losses)


def prep_fundus_model(torch, np, ckdir):
    """(f): prep_fundus.center_from_model on two synthetic 1024^2 frames at
    --detsize 640 (an 80x80 token grid) through build_model_fn, from a
    seeded flagship checkpoint."""
    from segtran_tpu_torch.cli import prep_fundus, test2d, train2d
    from segtran_tpu_torch.nn.init import init_with_reference_schemes
    from segtran_tpu_torch.train.checkpoint import save_checkpoint
    dev = torch.device("cuda")
    cpdir = os.path.join(ckdir, "prep")
    args = prep_fundus.build_argparser().parse_args(
        ["--images", "unused", "--out", "unused", "--cpdir", cpdir,
         "--iter", "1", "--bb", "eff-b4", "--layercompress", "1,1,2,2",
         "--bf16", "--device", "cuda"])
    targs = test2d.build_argparser().parse_args(OPTIONS_ARGV
                                                + ["--cpdir", cpdir])
    model, cfg = test2d.build_model(targs, train2d.task_settings(targs))
    init_with_reference_schemes(model, cfg, seed=2)
    save_checkpoint(cpdir, 1, model.state_dict(), cfg)
    del model
    model_fn = prep_fundus.build_model_fn(args, dev)
    frames = synthetic_fundus(np, PREP_FRAMES, seed=6, size=1024)
    perf = {}
    for i, f in enumerate(frames):
        img = (f["image"] * 255).round().astype(np.uint8)
        small = prep_fundus.resize_uint8(img, 640, device=dev)
        probs = model_fn(small.astype(np.float32) / 255.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cx, cy = prep_fundus.center_from_model(model_fn, img, 640, dev)
        s = time.perf_counter() - t0
        ok = (probs.shape == (640, 640, 3) and np.isfinite(probs).all()
              and 0 <= cx < 1024 and 0 <= cy < 1024)
        log(f"[fundus_options] prep_fundus center_from_model frame {i}: "
            f"centre ({cx}, {cy}) in {s:.3f} s; disc probability max "
            f"{float(probs[..., 1].max()):.3f}")
        perf[f"prep_frame{i}"] = dict(center=[cx, cy], s=s)
        if not ok:
            fail("prep_fundus model mode gave no finite centre in the frame")
    torch.cuda.empty_cache()
    return perf


def fundus_options(torch, np, epi, sa, ckdir, logger):
    """Phase 9: the remaining Segtran2d options at the flagship's width."""
    t0 = time.perf_counter()
    perf = {"flash": check_flash(torch, sa, FLASH_OPTION_CASES, ("bf16",)),
            "private": check_kernels(torch, epi, PRIVATE_NOSQUEEZE_CASES,
                                     ("bf16",))}
    perf["forwards"] = fundus_option_forwards(torch, np, epi, sa)
    perf.update(oct_eval(torch, np, epi, sa, ckdir, logger))
    perf["train"] = option_training(torch, np, ckdir, logger)
    perf.update(prep_fundus_model(torch, np, ckdir))
    perf["phase_s"] = time.perf_counter() - t0
    log(f"[fundus_options] phase in {perf['phase_s']:.1f} s")
    return perf


# ----------------------------------------------------------- phase 10 ----

# The kernels at this phase's shapes (bf16, the dtype of its paths): the
# flash forward at the 2.5D model's in- and out-squeeze (eff-b3, D = F =
# 1536; N = 9408 tokens at the 112x112x96 crop at batch 4, 4704 with
# --dgroup 2, 34560 at a 160x192x144 whole volume) and at the 3-D
# non-squeezed self-attention (4 modes of D = 256, F = 1024; Q = N = 2352
# at the recipe crop, 8640 at 160x192x144, 18000 at 240x240x155); the flash
# backward at the 2.5D in-squeeze (N = 9408, batch 4) and the 3-D
# self-attention at N = 8640; the epilogue at F = 1536 (the whole-volume
# 2.5D forward: the per-mode tier without --fused, P [1,4,34560,1024]; the
# private tier with it, mid [1,4,34560,1536]). The 3-D non-squeezed private
# tier (mid [1,4,8640,1024]) is EPILOGUE_CASES[4].
VOLUME_FLASH_CASES = [
    ("25d in-squeeze N=9408 bs4", 4, 1024, 9408, 1536, 1536, 1.0),
    ("25d out-squeeze N=9408 bs4", 16, 9408, 1024, 384, 1536, 1.0),
    ("25d in-squeeze N=4704 dgroup2 bs4", 4, 1024, 4704, 1536, 1536, 1.0),
    ("25d in-squeeze N=34560", 1, 1024, 34560, 1536, 1536, 1.0),
    ("25d out-squeeze N=34560", 4, 34560, 1024, 384, 1536, 1.0),
    ("3d self-attention N=2352", 4, 2352, 2352, 256, 1024, 1.0),
    ("3d self-attention N=8640", 4, 8640, 8640, 256, 1024, 1.0),
    ("3d self-attention N=18000", 4, 18000, 18000, 256, 1024, 1.0)]
VOLUME_FLASH_BWD_CASES = [
    ("25d in-squeeze N=9408 bs4", 4, 1024, 9408, 1536, 1536, 1.0),
    ("3d self-attention N=8640", 4, 8640, 8640, 256, 1024, 1.0)]
VOLUME_EPILOGUE_CASES = [
    ("fused_mid_output_pool_permode", "mid", 1, 4, 34560, 1024, 1536),
    ("fused_private_output_pool", "private", 1, 4, 34560, 0, 1536)]
SEG25D_ARGV = ["--task", "brats", "--segtran", "25d", "--translayers", "1",
               "--attractors", "1024", "--bf16", "--device", "cuda"]
SEG25D_TRAIN_BS, SEG25D_STEPS = 4, 3
VOLUME_TRAIN_BS, VOLUME_TRAIN_STEPS = 2, 2
# (label, train3d flags at the recipe crop with --fused, per-step launches:
# flash forward, recompute backward): attention dropout and kept scores
# keep the flash kernel off (JAX's gate)
VOLUME_TRAIN_CASES = [
    ("avgto3", ["--into3", "avgto3", "--dropout", "0"], (2, 2)),
    ("outdrop dropout 0.1", ["--outdrop", "--dropout", "0.1"], (0, 0)),
    ("outfpn 34", ["--outfpn", "34", "--dropout", "0"], (2, 2)),
    ("attnconsist", ["--attnconsist", "--dropout", "0"], (0, 0))]
# (label, flags, launches of one recipe-crop eval forward with --fused
# --fusedepi: flash forward, private tier, full tier)
VOLUME_POS_CASES = [("pos rand", ["--pos", "rand"], (2, 1, 0)),
                    ("pos sinu", ["--pos", "sinu"], (2, 1, 0)),
                    ("nosqueeze pos bias", ["--nosqueeze", "--pos", "bias"],
                     (0, 1, 0))]


def kernel_launches(epi, sa):
    """(flash forward, dK/dV, dQ, recompute backward, private tier, full
    tier) launches since the last reset."""
    return (sa.fused_cross_attention.launches,
            sa.flash_backward_dkdv.launches, sa.flash_backward_dq.launches,
            sa.cross_attention_bwd_recompute.launches,
            epi.fused_private_output_pool.launches,
            epi.fused_mid_output_pool.launches
            + epi.fused_mid_output_pool_permode.launches)


def reset_counts(epi, sa):
    epi.reset_launches()
    sa.reset_launches()


def memory_dataset(cls, vols, **fields):
    """``cls`` (a datasets3d class) over volumes held in memory: the GPU
    machine has no h5py. ``vols``: [{'image' as stored, 'label'}]."""
    class InMemory(cls):
        def __init__(self):
            self.case_list = [f"synthetic{i}" for i in range(len(vols))]
            self.epoch = 0
            for k, v in fields.items():
                setattr(self, k, v)

        def read(self, idx):
            return vols[idx]["image"], vols[idx]["label"]

        def stored_shape(self, idx):
            return vols[idx]["image"].shape
    return InMemory()


def volume_models(torch, test3d, argv, variants, seed):
    """{variant: eval model} built by test3d's factory from ``argv`` plus
    each variant's flags, all with the same seeded weights."""
    from segtran_tpu_torch.nn.init import init_with_reference_schemes
    models, state, cfgs = {}, None, {}
    for name, extra in variants.items():
        args = test3d.build_argparser().parse_args(
            argv + extra + ["--cpdir", "unused"])
        task = test3d.task_settings(args)
        model, cfg = test3d.build_model_and_config(args, task)
        if state is None:
            init_with_reference_schemes(model, cfg, seed)
            state = model.state_dict()
        else:
            model.load_state_dict(state, strict=True)
        models[name] = (model.cuda().eval(), args, task)
        cfgs[name] = cfg
    return models, cfgs


def volume_eval(torch, np, epi, sa, test3d, models, sample, wants, label):
    """evaluate_volume through each model, a warm call then a timed one;
    the launches of the timed call against ``wants`` {variant: (flash,
    private, full tier)}; probabilities against the 'unfused' variant's
    within MODEL_TOL."""
    dev = torch.device("cuda")
    out, perf = {}, {}
    for name, (model, args, task) in models.items():
        test3d.evaluate_volume(model, sample, args, task, dev)
        reset_counts(epi, sa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs, _, metrics = test3d.evaluate_volume(model, sample, args, task,
                                                   dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = kernel_launches(epi, sa)
        got = (got[0], got[4], got[5])
        out[name] = probs
        perf[name] = dict(seconds_per_volume=secs, launches=list(got),
                          dice=metrics["dice"])
        log(f"[volume_options] {label} {name}: {secs:.3f} s per volume, "
            f"launches (flash, private, full tier) {got} (want "
            f"{wants[name]}); dice (random weights) "
            f"{[round(d, 4) for d in metrics['dice']]}")
        if got != wants[name]:
            fail(f"{label} {name}: launches {got}, want {wants[name]}")
        if not bool(torch.isfinite(probs).all()):
            fail(f"{label} {name}: probabilities are not finite")
    ref = out["unfused"]
    for name, probs in out.items():
        if name == "unfused":
            continue
        mx, mean = (float(v) for v in ((probs - ref).abs().max(),
                                       (probs - ref).abs().mean()))
        perf[name].update(vs_unfused_max_abs=mx, vs_unfused_mean_abs=mean)
        log(f"[volume_options] {label} {name} vs unfused probabilities: max "
            f"{mx:.3e} mean {mean:.3e} (tol {MODEL_TOL[0]:g}/"
            f"{MODEL_TOL[1]:g})")
        if not (mx <= MODEL_TOL[0] and mean <= MODEL_TOL[1]):
            fail(f"{label} {name} disagrees with the unfused modules")
    return perf


def train_run(torch, np, epi, sa, train3d, argv, ds, ckdir, logger, label,
              want=None):
    """train3d.train() for --maxiter steps of ``argv`` on ``ds``; the
    launches (flash forward, dK/dV, dQ, recompute backward) against
    ``want`` per step. Returns (model, args, task, checkpoint dir, row)."""
    from segtran_tpu_torch.cli.test3d import probe_in_channels
    from segtran_tpu_torch.nn.init import init_with_reference_schemes
    dev = torch.device("cuda")
    args = train3d.build_argparser().parse_args(argv + ["--ckptdir", ckdir])
    task = train3d.task_settings(args)
    probe_in_channels(args, task, ds)
    model, cfg = train3d.build_model_and_config(args, task)
    init_with_reference_schemes(model, cfg, seed=0)
    model = model.to(dev)
    reset_counts(epi, sa)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt = train3d.train(model, ds, args, task, dev, cfg,
                         os.path.join(ckdir, label.replace(" ", "_")),
                         logger)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = kernel_launches(epi, sa)[:4]
    steps = args.maxiter
    wrote = os.path.isfile(os.path.join(ckpt, f"iter_{steps}.pt"))
    log(f"[volume_options] train {label}: {steps} train() steps at bs "
        f"{args.batch_size} in {wall:.2f} s (first step included), "
        f"launches (flash forward, dK/dV, dQ, recompute) {got}, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, iter_{steps}.pt "
        f"written {wrote}")
    if not wrote:
        fail(f"train {label}: no checkpoint")
    if want is not None and got != tuple(w * steps for w in want):
        fail(f"train {label}: launches {got}, want {want} per step")
    return model, args, task, ckpt, dict(
        wall_s=wall, launches=list(got),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def seg25d_training(torch, np, epi, sa, ckdir, logger):
    """(b): the 2.5D model at full width through train3d.train():
    SEG25D_STEPS steps at the 112x112x96 crop, bs SEG25D_TRAIN_BS (4 fits
    in 80 GB; each 2
    flash forwards, one flash backward pair at the in-squeeze's 9408 keys,
    one recompute backward at the out-squeeze's 1024), ms per step and peak
    memory; then one --dgroup 2 step (4704 keys: the flash backward
    too)."""
    from segtran_tpu_torch.cli import train3d
    from segtran_tpu_torch.data.datasets3d import BratsSet
    vols = [synthetic_volume(np, (160, 192, 144), seed=40 + i)
            for i in range(SEG25D_TRAIN_BS)]
    ds = memory_dataset(BratsSet, vols, mode="train",
                        crop_size=(112, 112, 96), seed=0)
    argv = SEG25D_ARGV + ["--fused", "--dropout", "0", "--seed", "0",
                          "--bs", str(SEG25D_TRAIN_BS), "--patchsize",
                          "112,112,96", "--saveiter", "100"]
    model, args, task, _, row = train_run(
        torch, np, epi, sa, train3d, argv + ["--maxiter", str(SEG25D_STEPS)],
        ds, ckdir, logger, "25d", want=(2, 1, 1, 1))
    cfg = model.cfg
    if (cfg.backbone_type != "eff-b3" or cfg.translayer_dims != (1536, 1536)
            or cfg.num_attractors != 1024 or cfg.num_modes != 4
            or cfg.inchan_to3_scheme != "stemconv" or not cfg.remat_blocks
            or cfg.dtype != torch.bfloat16):
        fail(f"unexpected 2.5D training config {cfg}")
    batch = {k: torch.from_numpy(np.stack([ds[i][k] for i in range(
        SEG25D_TRAIN_BS)])).cuda() for k in ("image", "label")}
    perf = train_step_perf(torch, train3d, model, args, task,
                           torch.device("cuda"), batch,
                           f"2.5D bs{SEG25D_TRAIN_BS}")
    if not perf["finite"]:
        fail("the 2.5D train step's loss or a gradient is not finite")
    perf.update(train_wall_s=row["wall_s"], launches=row["launches"],
                train_peak_mem_gb=row["peak_mem_gb"])
    del model, batch
    torch.cuda.empty_cache()
    *_, row = train_run(torch, np, epi, sa, train3d,
                        argv + ["--maxiter", "1", "--dgroup", "2"], ds,
                        ckdir, logger, "25d dgroup2", want=(2, 1, 1, 1))
    perf["dgroup2"] = row
    torch.cuda.empty_cache()
    return perf


def seg25d_wholevol(torch, np, epi, sa):
    """(c): test3d --segtran 25d --wholevol at full width on a synthetic
    160x192x144 volume: --fused --fusedepi (2 flash forwards, the private
    tier once), --fusedepi (the per-mode tier once: the all-modes tier's
    W2 does not fit JAX's VMEM arithmetic at F = 1536), each against the
    unfused modules."""
    from segtran_tpu_torch.cli import test3d
    route = epi.epilogue_route("mid", 4, 1024, 1536, torch.bfloat16)
    log(f"[volume_options] epilogue_route at the 2.5D out-squeeze (bf16, "
        f"M=4, A=1024, F=1536): {route}")
    if route != "per_mode":
        fail(f"the 2.5D out-squeeze's epilogue route is {route}")
    models, _ = volume_models(torch, test3d, SEG25D_ARGV + ["--wholevol"], {
        "unfused": [], "fused fusedepi": ["--fused", "--fusedepi"],
        "fusedepi": ["--fusedepi"]}, seed=5)
    perf = volume_eval(torch, np, epi, sa, test3d, models,
                       synthetic_volume(np, (160, 192, 144), seed=6), {
                           "unfused": (0, 0, 0), "fused fusedepi": (2, 1, 0),
                           "fusedepi": (0, 0, 1)}, "25d 160x192x144")
    del models
    torch.cuda.empty_cache()
    return perf


def brats_nosqueeze(torch, np, epi, sa, ckdir, logger):
    """(d) first half: the BraTS Segtran3d at full width with --nosqueeze:
    whole-volume eval at 160x192x144 and 240x240x155 with --fused
    --fusedepi (one flash forward at Q = N, the private tier once) against
    the unfused modules; one --fused --dropout 0 train() step at
    160x192x144, bs 1 (the flash backward at 8640 keys); the position
    codes' forwards at the recipe crop, launches as the gate gives."""
    from segtran_tpu_torch.cli import test3d, train3d
    from segtran_tpu_torch.data.datasets3d import BratsSet
    perf = {}
    models, _ = volume_models(torch, test3d, WHOLEVOL_ARGV + ["--nosqueeze"],
                              {"unfused": [],
                               "fused fusedepi": ["--fused", "--fusedepi"]},
                              seed=7)
    for i, shape in enumerate(VOLUMES):
        tag = "x".join(map(str, shape))
        perf[f"nosqueeze {tag}"] = volume_eval(
            torch, np, epi, sa, test3d, models,
            synthetic_volume(np, shape, seed=20 + i),
            {"unfused": (0, 0, 0), "fused fusedepi": (1, 1, 0)},
            f"nosqueeze {tag}")
        torch.cuda.empty_cache()
    del models
    torch.cuda.empty_cache()
    ds = memory_dataset(BratsSet, [synthetic_volume(np, (160, 192, 144), 30)],
                        mode="train", crop_size=(160, 192, 144), seed=0)
    model, *_, row = train_run(
        torch, np, epi, sa, train3d,
        TRAIN_ARGV + ["--nosqueeze", "--bs", "1", "--patchsize",
                      "160,192,144", "--inputsize", "160,192,144", "--bf16",
                      "--maxiter", "1", "--saveiter", "1"],
        ds, ckdir, logger, "nosqueeze 160x192x144", want=(1, 1, 1, 0))
    perf["nosqueeze train 160x192x144"] = row
    del model
    torch.cuda.empty_cache()
    x = torch.from_numpy(synthetic_volume(np, (112, 112, 96), 31)[
        "image"])[None].cuda()
    argv = ["--task", "brats", "--translayers", "1", "--attractors", "1024",
            "--inputsize", "112,112,96", "--bf16", "--device", "cuda"]
    for label, flags, want in VOLUME_POS_CASES:
        models, _ = volume_models(torch, test3d, argv + flags, {
            "fused": ["--fused", "--fusedepi"], "unfused": []}, seed=8)
        reset_counts(epi, sa)
        with torch.inference_mode():
            got = models["fused"][0](x)
            torch.cuda.synchronize()
            launches = kernel_launches(epi, sa)
            launches = (launches[0], launches[4], launches[5])
            ref = models["unfused"][0](x)
        probs, ref_probs = (torch.sigmoid(t.float()) for t in (got, ref))
        mx = float((probs - ref_probs).abs().max())
        mean = float((probs - ref_probs).abs().mean())
        log(f"[volume_options] {label} recipe-crop forward: launches "
            f"(flash, private, full tier) {launches} (want {want}); vs the "
            f"unfused modules max {mx:.3e} mean {mean:.3e}")
        if launches != want:
            fail(f"{label}: launches {launches}, want {want}")
        if not (bool(torch.isfinite(probs).all()) and mx <= MODEL_TOL[0]
                and mean <= MODEL_TOL[1]):
            fail(f"{label} disagrees with the unfused modules")
        perf[label] = dict(launches=list(launches), max_abs=mx,
                           mean_abs=mean)
        del models, got, ref
        torch.cuda.empty_cache()
    return perf


def brats_option_training(torch, np, epi, sa, ckdir, logger):
    """(d) second half: two train() steps each of VOLUME_TRAIN_CASES at the
    recipe crop, bs VOLUME_TRAIN_BS, --fused (launches as JAX's gate
    gives); atria (112x112x80, one channel) and msd (two stored
    modalities, --mod 0 --xyzpermute 1,2,0, three classes) through
    train3d's train() and test3d's evaluate_volume; one --testinterp
    volume."""
    from segtran_tpu_torch.cli import test3d, train3d
    from segtran_tpu_torch.data.datasets3d import (AtriaSet, BratsSet,
                                                   MSDSet)
    from segtran_tpu_torch.train.checkpoint import load_checkpoint
    dev = torch.device("cuda")
    perf = {}
    ds = memory_dataset(BratsSet, [synthetic_volume(np, (128, 128, 112), 50 + i)
                                   for i in range(VOLUME_TRAIN_BS)],
                        mode="train", crop_size=(112, 112, 96), seed=0)
    common = ["--task", "brats", "--translayers", "1", "--attractors",
              "1024", "--fused", "--bf16", "--device", "cuda", "--seed", "0",
              "--bs", str(VOLUME_TRAIN_BS), "--maxiter",
              str(VOLUME_TRAIN_STEPS), "--saveiter", "100"]
    for label, flags, (n_fwd, n_rec) in VOLUME_TRAIN_CASES:
        model, *_, row = train_run(torch, np, epi, sa, train3d,
                                   common + flags, ds, ckdir, logger, label,
                                   want=(n_fwd, 0, 0, n_rec))
        perf[label] = row
        del model
        torch.cuda.empty_cache()

    def task_volume(seed, shape, channels, classes, channels_last=True):
        rng = np.random.RandomState(seed)
        v = synthetic_volume(np, shape, seed)
        image = v["image"][..., :channels] + 0.1 * rng.rand(
            *shape, channels).astype(np.float32)
        label = np.minimum(v["label"], classes - 1).astype(np.uint8)
        return {"image": image if channels_last
                else np.ascontiguousarray(image.transpose(3, 0, 1, 2)),
                "label": label}

    for task_name, cls, shape, channels, classes, extra in (
            ("atria", AtriaSet, (128, 128, 88), 1, 2, []),
            ("msd", MSDSet, (120, 88, 128), 2, 3,
             ["--mod", "0", "--xyzpermute", "1,2,0", "--nclasses", "3"])):
        vols = [task_volume(60 + i, shape, channels, classes)
                for i in range(VOLUME_TRAIN_BS + 1)]
        argv = (["--task", task_name, "--translayers", "1", "--attractors",
                 "1024", "--fused", "--dropout", "0", "--bf16", "--device",
                 "cuda", "--seed", "0", "--bs", str(VOLUME_TRAIN_BS),
                 "--maxiter", str(VOLUME_TRAIN_STEPS), "--saveiter",
                 str(VOLUME_TRAIN_STEPS)] + extra)
        args = train3d.build_argparser().parse_args(argv)
        task = train3d.task_settings(args)
        xyz = (tuple(int(v) for v in args.xyz_permute.split(","))
               if args.xyz_permute else None)
        fields = dict(binarize=task["binarize"],
                      chosen_modality=args.chosen_modality, xyz_permute=xyz)
        train_ds = memory_dataset(cls, vols[:-1], mode="train", seed=0,
                                  crop_size=tuple(task["orig_patch_size"]),
                                  **fields)
        model, _, ttask, ckpt, row = train_run(
            torch, np, epi, sa, train3d, argv, train_ds, ckdir, logger,
            task_name)
        if ttask["orig_in_channels"] != 1:
            fail(f"{task_name}: {ttask['orig_in_channels']} input channels")
        del model
        eargs = test3d.build_argparser().parse_args(
            argv[:2] + ["--translayers", "1", "--attractors", "1024",
                        "--bf16", "--device", "cuda", "--wholevol", "--fused",
                        "--fusedepi", "--cpdir", ckpt, "--iters",
                        str(VOLUME_TRAIN_STEPS)] + extra)
        etask = test3d.task_settings(eargs)
        test_ds = memory_dataset(cls, vols[-1:], mode="test", **fields)
        test3d.probe_in_channels(eargs, etask, test_ds)
        emodel, ecfg = test3d.build_model_and_config(eargs, etask)
        emodel.load_state_dict(load_checkpoint(
            os.path.join(ckpt, f"iter_{VOLUME_TRAIN_STEPS}"), ecfg))
        sample = test_ds[0]
        probs, _, metrics = test3d.evaluate_volume(
            emodel.to(dev).eval(), sample, eargs, etask, dev)
        log(f"[volume_options] {task_name}: image {sample['image'].shape}, "
            f"test3d dice (random start, {VOLUME_TRAIN_STEPS} steps) "
            f"{[round(d, 4) for d in metrics['dice']]}")
        if (tuple(probs.shape) != sample["image"].shape[:3] + (classes,)
                or not bool(torch.isfinite(probs).all())
                or not np.isfinite(metrics["dice"]).all()):
            fail(f"{task_name}: test3d's output is not finite "
                 f"{tuple(probs.shape)}")
        perf[task_name] = dict(row, dice=metrics["dice"])
        del emodel, probs
        torch.cuda.empty_cache()

    iargs = test3d.build_argparser().parse_args(
        ["--task", "brats", "--testinterp", "0.5", "--cpdir", "unused",
         "--device", "cuda"])
    sample = synthetic_volume(np, (160, 192, 144), seed=70)
    probs, _, metrics = test3d.evaluate_volume(None, sample, iargs,
                                               test3d.task_settings(iargs),
                                               dev)
    log(f"[volume_options] --testinterp 0.5 at 160x192x144: dice "
        f"{[round(d, 4) for d in metrics['dice']]}")
    if not min(metrics["dice"]) > 0.5:
        fail("--testinterp 0.5 scored the ground truth below 0.5 Dice")
    perf["testinterp"] = dict(dice=metrics["dice"])
    return perf


def volume_options(torch, np, epi, sa, ckdir, logger):
    """Phase 10: the 2.5D model and the 3-D CLIs' options at full width."""
    t0 = time.perf_counter()
    perf = {"flash": check_flash(torch, sa, VOLUME_FLASH_CASES, ("bf16",)),
            "flash_backward": check_flash_backward(
                torch, sa, VOLUME_FLASH_BWD_CASES, ("bf16",)),
            "epilogue": check_kernels(torch, epi, dtypes=("bf16",),
                                      cases=VOLUME_EPILOGUE_CASES)}
    perf["train_25d"] = seg25d_training(torch, np, epi, sa, ckdir, logger)
    perf["wholevol_25d"] = seg25d_wholevol(torch, np, epi, sa)
    perf.update(brats_nosqueeze(torch, np, epi, sa, ckdir, logger))
    perf.update(brats_option_training(torch, np, epi, sa, ckdir, logger))
    perf["phase_s"] = time.perf_counter() - t0
    log(f"[volume_options] phase in {perf['phase_s']:.1f} s")
    return perf


# ----------------------------------------------------------- phase 11 ----

# the flagship in train2d's flags (bf16) and the Polyformer's U-Net
DA_ARGV = ["--task", "fundus", "--bb", "eff-b4", "--translayers", "3",
           "--layercompress", "1,1,2,2", "--attractors", "256",
           "--device", "cuda"]
UNET_DA_ARGV = ["--task", "fundus", "--net", "unet-scratch", "--attractors",
                "256", "--bf16", "--device", "cuda"]
MINCE_FLAGS = ["--nosqueeze", "--mince", "--mincescales", "2,1",
               "--minceprops", "1,1"]
DA_BS, DA_FRAMES, DA_STEPS, DA_OPTION_STEPS, DA_FP32_BS = 6, 12, 3, 2, 2
# flash forwards of one --adv --fused step: 6 per pass, target and source
DA_FLASH_PER_STEP = 12
# (label, flags, flash forward launches per step): the second pass of
# --adv doubles them, kept scores (--attnconsist) shut the gate (JAX's),
# --attndiag and --tunebn run without --fused
DA_OPTION_CASES = [
    ("adv mask", ["--adv", "mask", "--fused"], 12),
    ("adda", ["--adv", "feat", "--adda", "--fused"], 12),
    ("vcdr sep", ["--vcdr", "sep", "--vcdrestimstart", "0",
                  "--vcdrnetstart", "0", "--fused"], 6),
    ("attnconsist", ["--attnconsist", "--fused"], 0),
    ("attndiag", ["--attndiag", "1"], 0),
    ("tunebn", ["--tunebn"], 0),
    ("contrast", ["--contrastweight", "0.01", "--negcontrast", "--reffeatcp",
                  "BANK", "--numreffeat", "1000", "--fused"], 6)]


class _Lines(logging.Handler):
    """Keeps the messages a logger emits (train()'s log lines)."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def da_train(torch, epi, sa, argv, frames, src, ckdir, logger, label,
             cp=None):
    """train2d.train() of ``argv`` from seed 0 (``cp`` loaded as train2d's
    --cp loads it) on in-memory frames, ``src`` as the --sourceds set.
    Returns (model, args, task, cfg, checkpoint dir, the net's state before
    training on the CPU, row: wall, launches, peak memory, log lines)."""
    from segtran_tpu_torch.cli import train2d
    from segtran_tpu_torch.nn.init import init_with_reference_schemes
    from segtran_tpu_torch.train.checkpoint import load_checkpoint
    dev = torch.device("cuda")
    args = train2d.build_argparser().parse_args(
        argv + ["--seed", "0", "--logiter", "1", "--ckptdir", ckdir])
    task = train2d.task_settings(args)
    model, cfg = train2d.build_model_and_config(args, task)
    init_with_reference_schemes(model, cfg, seed=0)
    if cp is not None:
        train2d.load_into(model, load_checkpoint(cp), logger)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model = model.to(dev)
    lines = _Lines()
    logger.addHandler(lines)
    reset_counts(epi, sa)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        ckpt = train2d.train(model, frames, args, task, dev, cfg,
                             os.path.join(ckdir, label.replace(" ", "_")),
                             logger, source_dataset=src)
        torch.cuda.synchronize()
    finally:
        logger.removeHandler(lines)
    wall = time.perf_counter() - t0
    got = kernel_launches(epi, sa)
    peak = torch.cuda.max_memory_allocated() / 1e9
    wrote = os.path.isfile(os.path.join(ckpt, f"iter_{args.maxiter}.pt"))
    log(f"[da] train {label}: {args.maxiter} train() steps at bs "
        f"{args.batch_size} in {wall:.2f} s (first step included), launches "
        f"(flash forward, dK/dV, dQ, recompute, private, full) {got}, peak "
        f"{peak:.2f} GB, iter_{args.maxiter}.pt written {wrote}")
    if not wrote:
        fail(f"train {label}: no checkpoint")
    return model, args, task, cfg, ckpt, before, dict(
        wall_s=wall, launches=list(got), peak_mem_gb=peak,
        lines=lines.lines)


def polyformer_recipe(torch, np, epi, sa, ckdir, logger):
    """(a): --polyformer source, 3 steps; --polyformer target --targetopt
    k --adv feat --reconweight 0.1 from it, 3 steps (only K and running
    statistics move; no flash launch); test2d and one served batch on the
    target checkpoint."""
    from segtran_tpu_torch.cli import serve, test2d, train2d
    from segtran_tpu_torch.train.checkpoint import (load_checkpoint,
                                                    net_state_dict)
    frames = synthetic_fundus(np, DA_FRAMES, seed=10)
    src = synthetic_fundus(np, DA_FRAMES, seed=11)
    argv = UNET_DA_ARGV + ["--bs", str(DA_BS), "--maxiter", str(DA_STEPS),
                           "--saveiter", str(DA_STEPS)]
    *_, ckpt_s, _, row_s = da_train(
        torch, epi, sa, argv + ["--polyformer", "source"], frames, None,
        ckdir, logger, "polyformer source")
    model, args, task, _, ckpt_t, before, row_t = da_train(
        torch, epi, sa, argv + ["--polyformer", "target", "--targetopt", "k",
                                "--adv", "feat", "--sourceds", "rim",
                                "--reconweight", "0.1"],
        frames, src, ckdir, logger, "polyformer target",
        cp=os.path.join(ckpt_s, f"iter_{DA_STEPS}"))
    step_ms = da_step_ms(torch, np, epi, sa, model, args, task, None,
                         frames, src, "polyformer target --adv feat")
    saved = load_checkpoint(os.path.join(ckpt_t, f"iter_{DA_STEPS}"))
    # the aux modules start from their seeds: rebuilt, they are the start
    start = {f"net.{k}": v for k, v in before.items()}
    start.update(train2d.build_aux_modules(args, task, None).state_dict())
    moved = sorted(k for k, v in saved.items()
                   if not torch.equal(v, start[k]))
    moved_params = [k for k in moved if "running_" not in k]
    want = ["net.polyformer.polyformer_layers.0.in_ator_trans.key.bias",
            "net.polyformer.polyformer_layers.0.in_ator_trans.key.weight"]
    flash = row_s["launches"][:4] + row_t["launches"][:4]
    log(f"[da] polyformer target --targetopt k: {len(moved)} of {len(saved)} "
        f"tensors moved, parameters among them {moved_params}; the "
        f"discriminator and recon head unchanged "
        f"{not any(k.startswith(('discriminator.', 'recon.')) for k in moved_params)}; "
        f"flash launches of both runs {flash}")
    if moved_params != want or any(flash):
        fail("the Polyformer target run moved other parameters than K, or "
             "launched a flash kernel")
    # test2d and serve on the target checkpoint
    targv = (["--task", "fundus", "--net", "unet-scratch", "--polyformer",
              "target", "--attractors", "256", "--bf16", "--device", "cuda",
              "--cpdir", ckpt_t, "--iters", str(DA_STEPS), "--bs",
              str(CLI_EVAL_FRAMES), "--vcdr"])
    targs = test2d.build_argparser().parse_args(targv)
    ttask = train2d.task_settings(targs)
    tmodel, _ = test2d.build_model(targs, ttask)
    tmodel.load_state_dict(net_state_dict(saved), strict=True)
    tmodel = tmodel.cuda().eval()
    eval_frames = synthetic_fundus(np, CLI_EVAL_FRAMES, seed=14)
    mean, std = train2d.load_stats(targs, "train")
    reset_counts(epi, sa)
    res = test2d.evaluate_checkpoint(tmodel, eval_frames, ttask, targs,
                                     logger, mean, std)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    test2d.evaluate_checkpoint(tmodel, eval_frames, ttask, targs, logger,
                               mean, std)
    torch.cuda.synchronize()
    spf = (time.perf_counter() - t0) / CLI_EVAL_FRAMES
    eval_flash = kernel_launches(epi, sa)[0]
    sargs = serve.build_argparser().parse_args(
        ["--task", "fundus", "--net", "unet-scratch", "--polyformer",
         "target", "--attractors", "256", "--bf16", "--device", "cuda",
         "--cpdir", ckpt_t, "--iter", str(DA_STEPS), "--maxbatch", "2"])
    engine = serve.InferenceEngine(sargs, logger)
    try:
        batch = np.stack([f["image"] for f in eval_frames[:2]])
        served = engine.forward(batch)
    finally:
        engine.close()
    log(f"[da] test2d --net unet-scratch --polyformer target: per-class "
        f"Dice {[round(float(d), 4) for d in res[:2]]}, vCDR error "
        f"{float(res[2]):.4f}, {spf:.4f} s per 576^2 frame, flash launches "
        f"{eval_flash}; served batch {served.shape}, finite "
        f"{bool(np.isfinite(served).all())}")
    if (not np.isfinite(res).all() or eval_flash
            or served.shape != (2, 576, 576, 3)
            or not np.isfinite(served).all()):
        fail("test2d or serve on the Polyformer checkpoint failed")
    del model, tmodel, engine
    torch.cuda.empty_cache()
    return dict(source=_row(row_s), target=_row(row_t),
                target_ms_per_step=step_ms[0], target_peak_gb=step_ms[1],
                eval_s_per_frame=spf, eval_dice=[float(d) for d in res[:2]],
                eval_vcdr_err=float(res[2]))


def _row(row):
    return {k: v for k, v in row.items() if k != "lines"}


def _da_batch(torch, np, frames, src, bs, dev):
    batch = {k: torch.from_numpy(np.stack([f[k] for f in frames[:bs]]))
             for k in ("image", "mask")}
    batch["source_image"] = torch.from_numpy(np.stack(
        [f["image"] for f in src[:bs]]))
    return {k: v.to(dev) for k, v in batch.items()}


def da_step_ms(torch, np, epi, sa, model, args, task, cfg, frames, src,
               label):
    """train()'s DA step (fresh aux modules and optimizer) on a fixed
    batch of DA_BS target and source frames: ms per step on the host
    clock (DA_STEPS steps after a warm one, ending in a synchronise),
    peak memory, flash forward launches per step."""
    from segtran_tpu_torch.cli import train2d
    dev = torch.device("cuda")
    aux = train2d.build_aux_modules(args, task, cfg).to(dev)
    wrapped = torch.nn.ModuleDict({"net": model, **aux})
    opt, clip = train2d.build_train_optimizer(wrapped, model, args)
    step = train2d.make_step(model, opt, args, task, dev, None, aux, clip)
    batch = _da_batch(torch, np, frames, src, DA_BS, dev)
    torch.cuda.reset_peak_memory_stats()
    step(batch)
    torch.cuda.synchronize()
    reset_counts(epi, sa)
    t0 = time.perf_counter()
    losses = [float(step(batch)["loss"]) for _ in range(DA_STEPS)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / DA_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    flash = sa.fused_cross_attention.launches / DA_STEPS
    log(f"[da] {label} step bs {DA_BS} + source bs {DA_BS}: {ms:.1f} ms per "
        f"step on the host clock ({DA_STEPS} steps after a warm one), peak "
        f"{peak:.2f} GB, {flash:g} flash forward launches per step, losses "
        f"{losses}")
    if not all(map(math.isfinite, losses)):
        fail(f"the {label} step's losses are not finite")
    del aux, wrapped, opt, step, batch
    torch.cuda.empty_cache()
    return ms, peak, flash


def flagship_da(torch, np, epi, sa, ckdir, logger):
    """(b): the flagship with --adv feat --fused --dropout 0 at bs 6
    (--sourcebs 6) through train(), 3 steps of 12 flash forwards each;
    then ms per step and peak memory of the step on a fixed batch; one
    fp32 step with --fused against one without."""
    from segtran_tpu_torch.cli import train2d
    dev = torch.device("cuda")
    frames = synthetic_fundus(np, DA_FRAMES, seed=12)
    src = synthetic_fundus(np, DA_FRAMES, seed=13)
    argv = DA_ARGV + ["--bf16", "--adv", "feat", "--fused", "--dropout", "0",
                      "--bs", str(DA_BS), "--sourcebs", str(DA_BS),
                      "--sourceds", "rim", "--maxiter", str(DA_STEPS),
                      "--saveiter", str(DA_STEPS)]
    model, args, task, cfg, _, _, row = da_train(
        torch, epi, sa, argv, frames, src, ckdir, logger, "flagship adv feat")
    want = (DA_FLASH_PER_STEP * DA_STEPS, 0, 0)
    if tuple(row["launches"][:3]) != want:
        fail(f"the --adv --fused steps launched (flash forward, dK/dV, dQ) "
             f"{tuple(row['launches'][:3])}, want {want}")
    ms, peak, flash = da_step_ms(torch, np, epi, sa, model, args, task, cfg,
                                 frames, src, "flagship --adv feat --fused")
    if flash != DA_FLASH_PER_STEP:
        fail("the flagship DA step's launches are wrong")
    del model
    torch.cuda.empty_cache()
    out = dict(train=_row(row), ms_per_step=ms, peak_mem_gb=peak,
               flash_per_step=flash)
    out.update(da_fused_vs_unfused_fp32(torch, np, epi, sa, frames, src))
    return out


def da_fused_vs_unfused_fp32(torch, np, epi, sa, frames, src):
    """One fp32 --adv feat step (TF32 off, bs 2, no update) with --fused
    and twice without, same weights and draws: the loss and every
    gradient within REMAT_TOL or REMAT_FLOOR times the two unfused runs'
    spread (the net's, the discriminator's)."""
    from segtran_tpu_torch.cli import train2d
    from segtran_tpu_torch.data.augment import draw_2d
    from segtran_tpu_torch.nn.init import init_with_reference_schemes
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = _da_batch(torch, np, frames, src, DA_FP32_BS, dev)
    state, draws, runs = None, None, []
    for fused in (True, False, False):
        args = train2d.build_argparser().parse_args(
            DA_ARGV + ["--adv", "feat", "--dropout", "0", "--bs",
                       str(DA_FP32_BS), "--sourcebs", str(DA_FP32_BS),
                       "--seed", "0"] + (["--fused"] if fused else []))
        task = train2d.task_settings(args)
        model, cfg = train2d.build_model_and_config(args, task)
        if state is None:
            init_with_reference_schemes(model, cfg, seed=0)
            state = model.state_dict()
            gen = torch.Generator(device="cuda").manual_seed(3)
            aug = train2d.aug_config(args, *train2d.load_stats(args, "train"))
            draws = (draw_2d(DA_FP32_BS, aug, gen),
                     draw_2d(DA_FP32_BS, aug, gen))
        model.load_state_dict(state, strict=True)
        aux = train2d.build_aux_modules(args, task, cfg).to(dev)
        model = model.to(dev)
        step = train2d.make_step(model, None, args, task, dev, None, aux,
                                 grad_clip=0.0)
        reset_counts(epi, sa)
        loss = float(step(batch, draws=draws[0], src_draws=draws[1])["loss"])
        flash = sa.fused_cross_attention.launches
        if flash != (DA_FLASH_PER_STEP if fused else 0):
            fail(f"the fp32 DA step (--fused {fused}) launched {flash} "
                 f"flash forwards")
        wrapped = torch.nn.ModuleDict({"net": model, **aux})
        runs.append((loss, {n: p.grad.clone()
                            for n, p in wrapped.named_parameters()
                            if p.grad is not None}))
        del model, aux, step, wrapped
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    (l_f, g_f), (l_u, g_u), (_, g_again) = runs
    g_max = max(float(g.abs().max()) for g in g_u.values())

    def rel(grads, n):
        g = g_u[n]
        return float((grads[n] - g).abs().max()) / max(
            float(g.abs().max()), REMAT_NOISE * g_max)

    w_f = max((rel(g_f, n), n) for n in g_u)
    w_floor = max((rel(g_again, n), n) for n in g_u)
    tol = max(REMAT_TOL["grad"], REMAT_FLOOR * w_floor[0])
    loss_rel = abs(l_f - l_u) / abs(l_u)
    log(f"[da] fp32 --adv feat step bs {DA_FP32_BS}, --fused ("
        f"{DA_FLASH_PER_STEP} flash forwards) vs unfused: loss {l_f!r} vs "
        f"{l_u!r} (rel {loss_rel:.2e}, tol "
        f"{TRAIN_TOL['loss_rel']:g}); worst gradient max |diff| / max "
        f"|unfused| {w_f[0]:.2e} ({w_f[1]}) over {len(g_u)} tensors; two "
        f"unfused runs {w_floor[0]:.2e} ({w_floor[1]}); tol {tol:.2e}")
    if set(g_f) != set(g_u) or not all(bool(torch.isfinite(g).all())
                                       for g in g_f.values()):
        fail("the fused fp32 DA step's gradients are missing or not finite")
    if loss_rel > TRAIN_TOL["loss_rel"] or w_f[0] > tol:
        fail("the fused fp32 DA step disagrees with the unfused one")
    return dict(fp32_loss_rel=loss_rel, fp32_worst_grad=w_f[0],
                fp32_worst_grad_tensor=w_f[1],
                fp32_unfused_rerun_worst_grad=w_floor[0])


def da_options(torch, np, epi, sa, ckdir, logger):
    """(c): two train() steps of each DA_OPTION_CASES flag set at the
    flagship's width, bf16, bs 6, --dropout 0: launches, finite weights;
    --tunebn leaves every parameter bit-identical and moves the running
    statistics; --attndiag 1 logs its line each step; the contrast bank
    is a seeded .npz of 3 x 1200 448-wide features."""
    from segtran_tpu_torch.train.checkpoint import (load_checkpoint,
                                                    net_state_dict)
    frames = synthetic_fundus(np, DA_FRAMES, seed=15)
    src = synthetic_fundus(np, DA_FRAMES, seed=16)
    bank = os.path.join(ckdir, "bank.npz")
    os.makedirs(ckdir, exist_ok=True)
    rng = np.random.RandomState(0)
    np.savez(bank, features=rng.randn(3600, 448).astype(np.float32),
             labels=np.repeat([0, 1, 2], 1200))
    perf = {}
    for label, flags, per_step in DA_OPTION_CASES:
        argv = DA_ARGV + ["--bf16", "--dropout", "0", "--bs", str(DA_BS),
                          "--sourceds", "rim", "--maxiter",
                          str(DA_OPTION_STEPS), "--saveiter",
                          str(DA_OPTION_STEPS)]
        model, _, _, _, ckpt, before, row = da_train(
            torch, epi, sa, argv + [bank if f == "BANK" else f
                                    for f in flags],
            frames, src, ckdir, logger, label)
        saved = net_state_dict(load_checkpoint(
            os.path.join(ckpt, f"iter_{DA_OPTION_STEPS}")))
        finite = all(bool(torch.isfinite(v).all()) for v in saved.values())
        ok = finite and row["launches"][0] == per_step * DA_OPTION_STEPS
        if label == "tunebn":
            params = {n for n, _ in model.named_parameters()}
            same = all(torch.equal(saved[n], before[n]) for n in params)
            stats = any(not torch.equal(saved[n], before[n])
                        for n in saved if n.endswith("running_mean"))
            row.update(params_identical=same, stats_moved=stats)
            ok = ok and same and stats
        if label == "attndiag":
            n = sum("max-attn" in line for line in row["lines"])
            row["attn_diag_lines"] = n
            ok = ok and n == DA_OPTION_STEPS
        perf[label] = _row(row)
        log(f"[da] {label}: finite {finite}, flash forwards "
            f"{row['launches'][0]} (want {per_step * DA_OPTION_STEPS})"
            + (f", parameters bit-identical {row['params_identical']}, "
               f"running statistics moved {row['stats_moved']}"
               if label == "tunebn" else "")
            + (f", {row['attn_diag_lines']} max-attn lines"
               if label == "attndiag" else ""))
        if not ok:
            fail(f"the DA option {label} failed")
        del model
        torch.cuda.empty_cache()
    return perf


def mince_paths(torch, np, epi, sa, ckdir, logger):
    """(d): --nosqueeze --mince --mincescales 2,1 --minceprops 1,1 at the
    flagship's width: test2d's evaluate_checkpoint with --fused on 4
    frames (no flash launch), and two train() steps."""
    from segtran_tpu_torch.cli import test2d, train2d
    from segtran_tpu_torch.nn.init import init_with_reference_schemes
    frames = synthetic_fundus(np, 4, seed=17)
    targs = test2d.build_argparser().parse_args(
        DA_ARGV + ["--bf16", "--fused", "--cpdir", ckdir, "--bs", "4"]
        + MINCE_FLAGS)
    task = train2d.task_settings(targs)
    model, cfg = test2d.build_model(targs, task)
    init_with_reference_schemes(model, cfg, seed=0)
    model = model.cuda().eval()
    mean, std = train2d.load_stats(targs, "train")
    test2d.evaluate_checkpoint(model, frames, task, targs, logger, mean, std)
    reset_counts(epi, sa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = test2d.evaluate_checkpoint(model, frames, task, targs, logger,
                                     mean, std)
    torch.cuda.synchronize()
    spf = (time.perf_counter() - t0) / len(frames)
    flash = kernel_launches(epi, sa)[0]
    del model
    torch.cuda.empty_cache()
    *_, row = da_train(torch, epi, sa, DA_ARGV + [
        "--bf16", "--dropout", "0", "--bs", str(DA_BS), "--maxiter",
        str(DA_OPTION_STEPS), "--saveiter", str(DA_OPTION_STEPS), "--fused"]
        + MINCE_FLAGS, synthetic_fundus(np, DA_FRAMES, seed=18), None,
        ckdir, logger, "mince")
    log(f"[da] mince test2d --fused: {spf:.4f} s per 576^2 frame, Dice "
        f"(random weights) {[round(float(d), 4) for d in res]}, flash "
        f"launches {flash}; mince train flash launches {row['launches'][0]}")
    if flash or row["launches"][0] or not np.isfinite(res).all():
        fail("a mince path launched a flash kernel or is not finite")
    torch.cuda.empty_cache()
    return dict(eval_s_per_frame=spf, train=_row(row))


def da_phase(torch, np, epi, sa, ckdir, logger):
    """Phase 11: domain adaptation, the Polyformer and the mince layers."""
    t0 = time.perf_counter()
    perf = {"polyformer": polyformer_recipe(torch, np, epi, sa, ckdir,
                                            logger),
            "flagship": flagship_da(torch, np, epi, sa, ckdir, logger),
            "options": da_options(torch, np, epi, sa, ckdir, logger),
            "mince": mince_paths(torch, np, epi, sa, ckdir, logger)}
    perf["phase_s"] = time.perf_counter() - t0
    log(f"[da] phase in {perf['phase_s']:.1f} s")
    return perf


# ----------------------------------------------------------- phase 12 ----

# The kernels at the shapes of the recipe on ResNet-101 (--bb resnet101,
# --infpn 34, translayers 2048 -> 2048 -> 1024 -> 512, 4 modes, 256
# attractors, batch 8 of 288^2 patches: N = 36^2 = 1296 tokens at stride
# 8): the six flash calls of a --fused forward (the in-squeezes, 256
# attractors <- 1296 tokens at D = F = 2048, 2048, 1024; the out-squeezes,
# 4 modes of D = 512, 512, 256 with V W1 at F = 2048, 1024, 512), the full
# tier of --fusedepi (per-mode at F = 2048 and 1024, all modes at 512) and
# the private tier of --fused --fusedepi (F = 1024 and 512; F = 2048 runs
# the modules, as in JAX). D = F = 2048 is a cluster of 8 CTAs of 256
# columns for both kernels.
ZOO_FLASH_CASES = [
    ("resnet101 in-squeeze D=F=2048", 8, 256, 1296, 2048, 2048, 1.0),
    ("resnet101 in-squeeze D=F=1024", 8, 256, 1296, 1024, 1024, 1.0),
    ("resnet101 out-squeeze D=512 F=2048", 32, 1296, 256, 512, 2048, 1.0),
    ("resnet101 out-squeeze D=512 F=1024", 32, 1296, 256, 512, 1024, 1.0),
    ("resnet101 out-squeeze D=256 F=512", 32, 1296, 256, 256, 512, 1.0)]
ZOO_EPILOGUE_CASES = [
    ("fused_mid_output_pool_permode", "mid", 8, 4, 1296, 256, 2048),
    ("fused_mid_output_pool_permode", "mid", 8, 4, 1296, 256, 1024),
    ("fused_mid_output_pool", "mid", 8, 4, 1296, 256, 512),
    ("fused_private_output_pool", "private", 8, 4, 1296, 0, 1024),
    ("fused_private_output_pool", "private", 8, 4, 1296, 0, 512)]
ZOO_SEGTRAN_ARGV = ["--task", "fundus", "--bb", "resnet101", "--infpn",
                    "34", "--translayers", "3", "--layercompress",
                    "1,1,2,2", "--attractors", "256", "--bf16", "--device",
                    "cuda"]
# (label, flags, launches of one batch-8 forward: flash forward, private
# tier, full tier)
ZOO_SEGTRAN_CASES = [("fusedepi", ["--fusedepi"], (0, 0, 3)),
                     ("fused fusedepi", ["--fused", "--fusedepi"],
                      (6, 2, 0))]
ZOO_BS, ZOO_SEG_STEPS, ZOO_STEPS, ZOO_EVAL_FRAMES = 6, 3, 2, 8
# every zoo net at its published width through the CLIs
ZOO_NETS = [("unet eff-b4", ["--net", "unet", "--bb", "eff-b4"]),
            ("unet resnet34", ["--net", "unet", "--bb", "resnet34"]),
            ("nestedunet", ["--net", "nestedunet"]),
            ("unet3plus", ["--net", "unet3plus"]),
            ("attunet", ["--net", "attunet"]),
            ("r2attunet", ["--net", "r2attunet"]),
            ("dunet", ["--net", "dunet"]),
            ("transunet", ["--net", "transunet", "--bb", "resnet50"]),
            ("setr", ["--net", "setr"]),
            ("deeplabv3", ["--net", "deeplabv3", "--bb", "resnet101"]),
            ("deeplabv3plus", ["--net", "deeplabv3plus", "--bb",
                               "resnet101"]),
            ("pranet", ["--net", "pranet"]),
            ("nnunet", ["--net", "nnunet"])]
# card against CPU, fp32 probabilities of one eval forward (TF32 off)
ZOO_CPU_TOL = 1e-3


def zoo_segtran_forwards(torch, np, epi, sa, card):
    """(b): Segtran2d --bb resnet101 at full width through test2d's
    factory, a padded batch of 8 288^2 patches, with --fusedepi and with
    --fused --fusedepi against the unfused modules on the same seeded
    weights; launches asserted; each forward timed, the fused one
    profiled."""
    from segtran_tpu_torch.cli import test2d, train2d
    from segtran_tpu_torch.nn.init import init_with_reference_schemes
    x = fundus_batch(torch, 8, seed=21)["image"]
    state, perf, ref = None, {}, None
    for label, flags, want in [("unfused", [], (0, 0, 0))] \
            + ZOO_SEGTRAN_CASES:
        args = test2d.build_argparser().parse_args(
            ZOO_SEGTRAN_ARGV + flags + ["--cpdir", "unused"])
        model, cfg = test2d.build_model(args, train2d.task_settings(args))
        if cfg.translayer_dims != (2048, 2048, 1024, 512):
            fail(f"unexpected resnet101 config {cfg.translayer_dims}")
        if state is None:
            init_with_reference_schemes(model, cfg, seed=21)
            state = model.state_dict()
        else:
            model.load_state_dict(state, strict=True)
        model = model.cuda().eval()
        reset_counts(epi, sa)
        with torch.inference_mode():
            out = model(x)
            torch.cuda.synchronize()
            launches = option_launches(epi, sa)
            probs = torch.sigmoid(out.float()).cpu().numpy()
            ms = cuda_ms(torch, lambda: model(x), iters=3)
        row = dict(launches=list(launches), ms_batch8=ms)
        if ref is None:
            ref = probs
        else:
            mx, mean = compare(probs, ref)
            row.update(max_abs=mx, mean_abs=mean)
            if not (np.isfinite(probs).all() and mx <= MODEL_TOL[0]
                    and mean <= MODEL_TOL[1]):
                fail(f"resnet101 {label} disagrees with the unfused modules "
                     f"(max {mx:.3e}, mean {mean:.3e})")
        if launches != want:
            fail(f"resnet101 {label}: launches (flash, private, full tier) "
                 f"{launches}, want {want}")
        if label == "fused fusedepi":
            with torch.inference_mode():
                row.update(profile_forward(
                    torch, lambda: (model(x), torch.cuda.synchronize()),
                    "one resnet101 --fused --fusedepi batch-8 forward",
                    {"flash forward": ("fwd_kernel", "fwd_merge_kernel"),
                     "epilogue kernels": EPILOGUE_KERNELS,
                     "convolutions": ("conv", "xmma", "cudnn", "implicit")}))
        log(f"[zoo] resnet101 {label}: launches (flash, private, full tier) "
            f"{launches} (want {want}); batch-8 forward {ms:.2f} ms"
            + (f"; probabilities vs unfused max {row['max_abs']:.3e} mean "
               f"{row['mean_abs']:.3e} (tol {MODEL_TOL[0]:g}/"
               f"{MODEL_TOL[1]:g})" if "max_abs" in row else "")
            + f" on {card}")
        perf[label] = row
        del model
        torch.cuda.empty_cache()
    return perf


def zoo_segtran_training(torch, np, epi, sa, ckdir, logger, card):
    """(c): train2d.train() with --net segtran --bb resnet101 --fused
    --dropout 0 at bs 6 on synthetic 576^2 frames, 3 steps of 6 flash
    forwards each and no flash backward (N = 1296 < FLASH_BWD_MIN_N); then
    the CLI step's ms per step (host clock, ending in a synchronise) and
    peak memory."""
    from segtran_tpu_torch.cli import train2d
    from segtran_tpu_torch.nn.init import init_with_reference_schemes
    from segtran_tpu_torch.train.trainer import build_optimizer
    dev = torch.device("cuda")
    frames = synthetic_fundus(np, 2 * ZOO_BS, seed=22)
    args = train2d.build_argparser().parse_args(
        ZOO_SEGTRAN_ARGV + ["--fused", "--dropout", "0", "--seed", "0",
                            "--bs", str(ZOO_BS), "--maxiter",
                            str(ZOO_SEG_STEPS), "--saveiter",
                            str(ZOO_SEG_STEPS), "--logiter", "1",
                            "--ckptdir", ckdir])
    task = train2d.task_settings(args)
    model, cfg = train2d.build_model_and_config(args, task)
    init_with_reference_schemes(model, cfg, seed=0)
    model = model.to(dev)
    reset_counts(epi, sa)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ckpt = train2d.train(model, frames, args, task, dev, cfg,
                         os.path.join(ckdir, "zoo_segtran"), logger)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches(epi, sa)
    want = (6 * ZOO_SEG_STEPS, 0, 0)
    wrote = os.path.isfile(os.path.join(ckpt, f"iter_{ZOO_SEG_STEPS}.pt"))
    if tuple(launches[:3]) != want or not wrote:
        fail(f"resnet101 --fused train(): (flash forward, dK/dV, dQ) "
             f"{tuple(launches[:3])}, want {want}; checkpoint {wrote}")
    opt = build_optimizer(model, lr=2e-4, decay=1e-4, t_total=100,
                          warmup_ratio=0.05)
    step = train2d.make_step(model, opt, args, task, dev)
    batch = {k: torch.from_numpy(np.stack([f[k] for f in frames[:ZOO_BS]]))
             .to(dev) for k in ("image", "mask")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(step(batch)["loss"]) for _ in range(2)]
    ms = (time.perf_counter() - t0) / 2 * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[zoo] train2d.train() --bb resnet101 --fused --dropout 0: "
        f"{ZOO_SEG_STEPS} steps at bs {ZOO_BS} in {wall:.2f} s (first step "
        f"included), launches (flash forward, dK/dV, dQ, recompute "
        f"backward, private, full tier) {launches}; the CLI step {ms:.1f} "
        f"ms per step on the host clock (losses {losses}), peak "
        f"{peak:.2f} GB on {card}")
    if not all(math.isfinite(v) for v in losses):
        fail("the resnet101 train steps gave a non-finite loss")
    del model, step, opt
    torch.cuda.empty_cache()
    return dict(train_wall_s=wall, launches=list(launches), ms_per_step=ms,
                peak_mem_gb=peak, losses=losses)


def zoo_net(torch, np, epi, sa, label, flags, frames, eval_frames, ckdir,
            logger, card):
    """(d) for one net: 2 train2d.train() steps at bs 6 (bf16), the CLI
    step's ms per step and peak memory, test2d.evaluate_checkpoint on 8
    frames, and the fp32 eval forward of the checkpoint on the card
    against the same forward on CPU tensors (TF32 off)."""
    from segtran_tpu_torch.cli import test2d, train2d
    from segtran_tpu_torch.train.checkpoint import load_checkpoint
    dev = torch.device("cuda")
    base = ["--task", "fundus", "--device", "cuda"] + flags
    args = train2d.build_argparser().parse_args(
        base + ["--bf16", "--seed", "0", "--bs", str(ZOO_BS), "--maxiter",
                str(ZOO_STEPS), "--saveiter", str(ZOO_STEPS), "--logiter",
                "1", "--ckptdir", ckdir])
    task = train2d.task_settings(args)
    model, cfg = train2d.build_model_and_config(args, task)
    n_params = sum(p.numel() for p in model.parameters())
    model = model.to(dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ckpt = train2d.train(model, frames, args, task, dev, cfg,
                         os.path.join(ckdir, label.replace(" ", "_")),
                         logger)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    opt, clip = train2d.build_train_optimizer(model, model, args)
    step = train2d.make_step(model, opt, args, task, dev, grad_clip=clip)
    batch = {k: torch.from_numpy(np.stack([f[k] for f in frames[:ZOO_BS]]))
             .to(dev) for k in ("image", "mask")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(step(batch)["loss"]) for _ in range(2)]
    ms = (time.perf_counter() - t0) / 2 * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    del model, step, opt
    torch.cuda.empty_cache()
    # test2d on the checkpoint, then fp32 on the card against the CPU
    targs = test2d.build_argparser().parse_args(
        base + ["--cpdir", ckpt, "--iters", str(ZOO_STEPS), "--bs",
                str(ZOO_EVAL_FRAMES)])
    model, cfg = test2d.build_model(targs, task)
    model.load_state_dict(load_checkpoint(os.path.join(
        ckpt, f"iter_{ZOO_STEPS}"), cfg), strict=True)
    model = model.eval()
    mean, std = train2d.load_stats(targs, "train")
    x = torch.from_numpy(np.stack([f["image"] for f in eval_frames[:1]]))
    x = torch.nn.functional.interpolate(
        x.permute(0, 3, 1, 2), size=tuple(task["patch_size"]),
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fn = test2d.make_model_fn(model, mean, std, targs.gray_alpha,
                              torch.device("cpu"))
    with torch.inference_mode():
        cpu = torch.sigmoid(fn(x)).numpy()
    model = model.to(dev)
    fn = test2d.make_model_fn(model, mean, std, targs.gray_alpha, dev)
    with torch.inference_mode():
        gpu = torch.sigmoid(fn(x.to(dev))).cpu().numpy()
    torch.backends.cudnn.allow_tf32 = True
    cpu_diff = float(np.abs(gpu - cpu).max())
    res = test2d.evaluate_checkpoint(model, eval_frames, task, targs, logger,
                                     mean, std, dev)
    t0 = time.perf_counter()
    test2d.evaluate_checkpoint(model, eval_frames, task, targs, logger,
                               mean, std, dev)
    s_per_frame = (time.perf_counter() - t0) / len(eval_frames)
    del model
    torch.cuda.empty_cache()
    row = dict(params_m=n_params / 1e6, train_wall_s=wall, ms_per_step=ms,
               peak_mem_gb=peak, losses=losses,
               dice=[float(d) for d in res[:2]], s_per_frame=s_per_frame,
               card_vs_cpu_max_abs=cpu_diff)
    log(f"[zoo] {label}: {n_params / 1e6:.1f} M parameters; "
        f"train2d.train() {ZOO_STEPS} steps at bs {ZOO_BS} in {wall:.2f} s, "
        f"the CLI step {ms:.1f} ms (losses {losses}), peak {peak:.2f} GB; "
        f"test2d {s_per_frame:.4f} s per 576^2 frame, Dice "
        f"{row['dice']}; fp32 card vs CPU max |probability diff| "
        f"{cpu_diff:.3e} (tol {ZOO_CPU_TOL:g}) on {card}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"zoo {label}: non-finite loss")
    if not np.isfinite(res).all():
        fail(f"zoo {label}: test2d gave a non-finite Dice")
    if not cpu_diff <= ZOO_CPU_TOL:
        fail(f"zoo {label}: the card's fp32 forward disagrees with the CPU")
    return row


# (e) the 3-D zoo at its published widths (the CLIs' VNet: 16 filters,
# group norm; Modified3DUNet: 8 base filters), BraTS's 4 modalities and 4
# classes, bf16
ZOO3D_NETS = [("vnet", ["--net", "vnet"]), ("unet3d", ["--net", "unet"])]
ZOO3D_STEPS, ZOO3D_BS = 2, 4
ZOO3D_CPU_CROP = (64, 64, 32)


def zoo3d_net(torch, np, epi, sa, label, flags, make_ds, ckdir, logger,
              card):
    """(e) for one 3-D net: 2 train3d.train() steps at the recipe crop
    112x112x96, bs 4, on synthetic volumes, the CLI step's ms per step and
    peak memory; test3d's evaluate_volume on one 160x192x144 volume with
    --wholevol and with the sliding window; the fp32 eval forward on the
    card against the CPU on a 64x64x32 crop (TF32 off). No kernel
    launches."""
    from segtran_tpu_torch.cli import test3d, train3d
    from segtran_tpu_torch.train.trainer import build_optimizer
    dev = torch.device("cuda")
    reset_counts(epi, sa)
    args = train3d.build_argparser().parse_args(
        ["--task", "brats", "--bf16", "--device", "cuda", "--seed", "0",
         "--bs", str(ZOO3D_BS), "--maxiter", str(ZOO3D_STEPS), "--saveiter",
         str(ZOO3D_STEPS), "--ckptdir", ckdir] + flags)
    task = train3d.task_settings(args)
    model, cfg = train3d.build_model_and_config(args, task)
    n_params = sum(p.numel() for p in model.parameters())
    model = model.to(dev)
    ds = make_ds(tuple(task["orig_patch_size"]))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt = train3d.train(model, ds, args, task, dev, cfg,
                         os.path.join(ckdir, label), logger)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not os.path.isfile(os.path.join(ckpt, f"iter_{ZOO3D_STEPS}.pt")):
        fail(f"zoo3d {label}: train() wrote no checkpoint")
    opt = build_optimizer(model, lr=args.lr, decay=args.decay,
                          t_total=100, warmup_ratio=0.05)
    step = train3d.make_step(model, opt, args, task, dev)
    batch = {k: torch.from_numpy(np.stack([ds[i][k] for i in range(
        ZOO3D_BS)])).to(dev) for k in ("image", "label")}
    step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [float(step(batch)["loss"]) for _ in range(2)]
    ms = (time.perf_counter() - t0) / 2 * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    del step, opt, batch
    row = dict(params_m=n_params / 1e6, train_wall_s=wall, ms_per_step=ms,
               peak_mem_gb=peak, losses=losses)
    model.eval()
    sample = synthetic_volume(np, VOLUMES[0], seed=30)
    for how, extra in (("wholevol", ["--wholevol"]), ("sliding", [])):
        targs = test3d.build_argparser().parse_args(
            ["--task", "brats", "--bf16", "--device", "cuda", "--cpdir",
             ckpt] + flags + extra)
        test3d.evaluate_volume(model, sample, targs, task, dev)   # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs, _, metrics = test3d.evaluate_volume(model, sample, targs,
                                                   task, dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if (tuple(probs.shape) != VOLUMES[0] + (4,)
                or not bool(torch.isfinite(probs).all())
                or not np.isfinite(metrics["dice"]).all()):
            fail(f"zoo3d {label} {how}: probabilities {tuple(probs.shape)} "
                 f"or Dice not finite")
        row[f"{how}_s_per_volume"] = secs
        row[f"{how}_dice"] = [float(d) for d in metrics["dice"]]
        del probs
    # fp32 on the card against the CPU, the trained weights
    state = {k: v.float().cpu() for k, v in model.state_dict().items()}
    del model
    torch.cuda.empty_cache()
    eargs = test3d.build_argparser().parse_args(
        ["--task", "brats", "--device", "cpu", "--cpdir", ckpt] + flags)
    model, _ = test3d.build_model_and_config(eargs, task)
    model.load_state_dict(state, strict=True)
    model.eval()
    x = torch.from_numpy(synthetic_volume(np, ZOO3D_CPU_CROP, seed=31)[
        "image"])[None]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        cpu = torch.sigmoid(model(x)).numpy()
        model = model.to(dev)
        gpu = torch.sigmoid(model(x.to(dev))).cpu().numpy()
    torch.backends.cudnn.allow_tf32 = True
    cpu_diff = float(np.abs(gpu - cpu).max())
    row["card_vs_cpu_max_abs"] = cpu_diff
    launches = kernel_launches(epi, sa)
    del model
    torch.cuda.empty_cache()
    log(f"[zoo3d] {label}: {n_params / 1e6:.2f} M parameters; train3d.train() "
        f"{ZOO3D_STEPS} steps at bs {ZOO3D_BS} (112x112x96) in {wall:.2f} s, "
        f"the CLI step {ms:.1f} ms (losses {losses}), peak {peak:.2f} GB; "
        f"test3d 160x192x144 --wholevol {row['wholevol_s_per_volume']:.3f} "
        f"s, sliding window {row['sliding_s_per_volume']:.3f} s per volume; "
        f"fp32 card vs CPU max |probability diff| {cpu_diff:.3e} (tol "
        f"{ZOO_CPU_TOL:g}); kernel launches {launches} on {card}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"zoo3d {label}: non-finite loss")
    if not cpu_diff <= ZOO_CPU_TOL:
        fail(f"zoo3d {label}: the card's fp32 forward disagrees with the CPU")
    if any(launches):
        fail(f"zoo3d {label} launched kernels {launches}; it runs none")
    return row


def zoo3d_phase(torch, np, epi, sa, ckdir, logger, card):
    """Phase 12 (e): VNet and Modified3DUNet through train3d and test3d."""
    make_ds = synthetic_dataset(np, ZOO3D_BS, VOLUMES[0])
    nets = {}
    for label, flags in ZOO3D_NETS:
        nets[label] = zoo3d_net(torch, np, epi, sa, label, flags, make_ds,
                                ckdir, logger, card)
        shutil.rmtree(ckdir, ignore_errors=True)
    return nets


def zoo_phase(torch, np, epi, sa, ckdir, logger, card):
    """Phase 12: the 2-D zoo, Segtran2d on ResNet-101, and (e) the 3-D
    zoo."""
    t0 = time.perf_counter()
    perf = {"flash": check_flash(torch, sa, ZOO_FLASH_CASES),
            "epilogue": check_kernels(torch, epi, cases=ZOO_EPILOGUE_CASES)}
    perf["resnet101_forwards"] = zoo_segtran_forwards(torch, np, epi, sa,
                                                      card)
    perf["resnet101_train"] = zoo_segtran_training(torch, np, epi, sa, ckdir,
                                                   logger, card)
    frames = synthetic_fundus(np, 2 * ZOO_BS, seed=23)
    eval_frames = synthetic_fundus(np, ZOO_EVAL_FRAMES, seed=24)
    reset_counts(epi, sa)
    nets = {}
    for label, flags in ZOO_NETS:
        nets[label] = zoo_net(torch, np, epi, sa, label, flags, frames,
                              eval_frames, ckdir, logger, card)
        shutil.rmtree(ckdir, ignore_errors=True)
    launches = kernel_launches(epi, sa)
    if any(launches):
        fail(f"the zoo nets launched kernels {launches}; they run none")
    perf["nets"] = nets
    perf["nets3d"] = zoo3d_phase(torch, np, epi, sa, ckdir, logger, card)
    perf["phase_s"] = time.perf_counter() - t0
    log(f"[zoo] phase in {perf['phase_s']:.1f} s on {card}")
    return perf


# ----------------------------------------------------------- phase 13 ----

# Reference-format checkpoints (the reference's {'iter_num', 'model',
# 'args'} .pth), written from seeded port weights by tests/_torch_refsd.py
# and imported through convert.cli --strict: (a) the BraTS Segtran3d recipe
# (I3D, 1 translayer 1024 -> 1024, 1024 attractors) evaluated with test3d
# --wholevol --fused --fusedepi --bf16 (2 flash forwards, 1 private tier);
# (b) the fundus flagship (eff-b4 at stem stride 1, 1792 -> 1792 -> 896 ->
# 448, 256 attractors) on a batch of 8 288^2 patches with --fusedepi --bf16
# (1 per-mode, 2 all-modes epilogue launches); (c) the importer's VNet
# (batch norm, dropout) and Modified3DUNet. The imported state_dict must
# equal the seeded one tensor for tensor, and its probabilities those of
# the model that holds the seeded weights directly, within IMPORT_TOL (the
# same tensors through the same kernels).
IMPORT_TOL = 1e-6
IMPORT_3D_ARGS = {"num_classes": 4, "orig_in_channels": 4}


def import_checkpoint(torch, label, state, kind, args, ckdir, cfg=None):
    """Write ``state`` as a reference .pth of ``kind``, import it with
    ``convert.cli --strict``; (the imported state_dict, the import's wall
    seconds). Fails unless it equals ``state`` tensor for tensor."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _torch_refsd
    from segtran_tpu_torch.convert import cli
    from segtran_tpu_torch.train.checkpoint import load_checkpoint
    os.makedirs(ckdir, exist_ok=True)
    pth = _torch_refsd.write_reference_pth(
        os.path.join(ckdir, f"{label}.pth"), state, kind, args)
    t0 = time.perf_counter()
    path = cli.main(["--pth", pth, "--out", os.path.join(ckdir, label),
                     "--model", kind, "--strict"])
    wall = time.perf_counter() - t0
    sd = load_checkpoint(path, cfg)
    same = set(sd) == set(state) and all(
        torch.equal(sd[k], state[k].float()) for k in state)
    n = sum(v.numel() for v in sd.values())
    log(f"[import] {label}: {os.path.getsize(pth) / 1e6:.1f} MB reference "
        f".pth, {n / 1e6:.2f} M values imported in {wall:.2f} s; equal to "
        f"the seeded state_dict: {same}")
    if not same:
        fail(f"import {label}: the imported state_dict differs from the "
             f"seeded one")
    return sd, wall


def _probs_diff(torch, a, b):
    return float((a.float() - b.float()).abs().max())


def import_brats(torch, np, epi, sa, ckdir):
    """(a)"""
    from segtran_tpu_torch.cli import test3d
    from segtran_tpu_torch.models.segtran3d import init_segtran3d
    dev = torch.device("cuda")
    args = test3d.build_argparser().parse_args(
        WHOLEVOL_ARGV + ["--fused", "--fusedepi", "--cpdir", ckdir])
    task = test3d.task_settings(args)
    direct, cfg = test3d.build_model_and_config(args, task)
    if (cfg.translayer_dims != (1024, 1024) or cfg.num_attractors != 1024
            or cfg.backbone_type != "i3d"):
        fail(f"unexpected BraTS config {cfg}")
    state = init_segtran3d(direct, seed=40).state_dict()
    pth_args = dict(IMPORT_3D_ARGS, num_attractors=cfg.num_attractors,
                    num_translayers=1, num_modes=cfg.num_modes,
                    input_patch_size=tuple(task["input_patch_size"]),
                    tie_qk_scheme=cfg.tie_qk_scheme)
    sd, wall = import_checkpoint(torch, "brats_segtran3d", state,
                                 "segtran3d", pth_args, ckdir, cfg)
    imported, _ = test3d.build_model_and_config(args, task)
    imported.load_state_dict(sd, strict=True)
    sample = synthetic_volume(np, VOLUMES[0], seed=41)
    probs = {}
    for name, model in (("direct", direct), ("imported", imported)):
        model = model.to(dev).eval()
        reset_counts(epi, sa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs[name], _, metrics = test3d.evaluate_volume(model, sample, args,
                                                         task, dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = kernel_launches(epi, sa)
        launches = (got[0], got[4], got[5])
        model.cpu()
    diff = _probs_diff(torch, probs["imported"], probs["direct"])
    log(f"[import] BraTS Segtran3d 160x192x144 --wholevol --fused --fusedepi "
        f"--bf16 on the imported weights: {secs:.3f} s per volume, launches "
        f"(flash, private, full tier) {launches} (want (2, 1, 0)); max "
        f"|probability diff| vs the seeded model {diff:.3e} (tol "
        f"{IMPORT_TOL:g})")
    if launches != (2, 1, 0):
        fail(f"import BraTS: launches {launches}, want (2, 1, 0)")
    if not (diff <= IMPORT_TOL and bool(torch.isfinite(probs["imported"])
                                        .all())):
        fail("import BraTS: the imported model disagrees with the seeded one")
    return dict(import_s=wall, seconds_per_volume=secs,
                launches=list(launches), max_abs_vs_direct=diff,
                dice=[float(d) for d in metrics["dice"]])


def import_fundus(torch, np, epi, sa, ckdir):
    """(b)"""
    from segtran_tpu_torch.cli import test2d, train2d
    from segtran_tpu_torch.nn.init import init_with_reference_schemes
    args = test2d.build_argparser().parse_args(
        ["--task", "fundus", "--bb", "eff-b4", "--translayers", "3",
         "--layercompress", "1,1,2,2", "--attractors", "256", "--bf16",
         "--fusedepi", "--device", "cuda", "--cpdir", ckdir])
    task = train2d.task_settings(args)
    direct, cfg = test2d.build_model(args, task)
    if cfg.translayer_dims != (1792, 1792, 896, 448) \
            or cfg.num_attractors != 256:
        fail(f"unexpected fundus flagship config {cfg}")
    state = init_with_reference_schemes(direct, cfg, seed=42).state_dict()
    pth_args = {"backbone_type": cfg.backbone_type,
                "num_classes": cfg.num_classes,
                "num_attractors": cfg.num_attractors,
                "num_modes": cfg.num_modes, "num_translayers": 3,
                "translayer_compress_ratios": [1.0, 1.0, 2.0, 2.0],
                "in_fpn_layers": "34", "out_fpn_layers": "1234",
                "qk_have_bias": cfg.qk_have_bias,
                "tie_qk_scheme": cfg.tie_qk_scheme,
                "patch_size": tuple(task["patch_size"])}
    sd, wall = import_checkpoint(torch, "fundus_flagship", state,
                                 "segtran2d", pth_args, ckdir, cfg)
    imported, _ = test2d.build_model(args, task)
    imported.load_state_dict(sd, strict=True)
    x = fundus_batch(torch, 8, seed=43)["image"]
    probs = {}
    for name, model in (("direct", direct), ("imported", imported)):
        model = model.cuda().eval()
        reset_counts(epi, sa)
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            probs[name] = torch.sigmoid(model(x).float())
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = (epi.fused_mid_output_pool_permode.launches,
                    epi.fused_mid_output_pool.launches,
                    epi.fused_private_output_pool.launches,
                    sa.fused_cross_attention.launches)
        model.cpu()
    diff = _probs_diff(torch, probs["imported"], probs["direct"])
    log(f"[import] fundus flagship batch 8 x 288^2 --fusedepi --bf16 on the "
        f"imported weights: {ms:.2f} ms, launches (per-mode, all modes, "
        f"private tier, flash) {launches} (want (1, 2, 0, 0)); max "
        f"|probability diff| vs the seeded model {diff:.3e} (tol "
        f"{IMPORT_TOL:g})")
    if launches != (1, 2, 0, 0):
        fail(f"import fundus: launches {launches}, want (1, 2, 0, 0)")
    if not (diff <= IMPORT_TOL and bool(torch.isfinite(probs["imported"])
                                        .all())):
        fail("import fundus: the imported model disagrees with the seeded "
             "one")
    return dict(import_s=wall, ms_batch8=ms, launches=list(launches),
                max_abs_vs_direct=diff)


def import_zoo3d(torch, np, epi, sa, ckdir):
    """(c): the importer's VNet and Modified3DUNet, fp32, on a recipe
    crop."""
    from segtran_tpu_torch.convert import cli
    x = torch.from_numpy(synthetic_volume(np, (112, 112, 96), seed=45)[
        "image"])[None].cuda()
    rows = {}
    for kind in ("vnet", "unet3d"):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(44)
            direct = cli.build_model(kind, None, IMPORT_3D_ARGS)
        state = {k: v.clone() for k, v in direct.state_dict().items()}
        sd, wall = import_checkpoint(torch, kind, state, kind,
                                     IMPORT_3D_ARGS, ckdir)
        imported = cli.build_model(kind, None, IMPORT_3D_ARGS)
        imported.load_state_dict(sd, strict=True)
        reset_counts(epi, sa)
        with torch.inference_mode():
            probs = [torch.sigmoid(m.cuda().eval()(x)) for m in (direct,
                                                                 imported)]
        diff = _probs_diff(torch, probs[1], probs[0])
        launches = kernel_launches(epi, sa)
        norm = ("batch norm, dropout" if kind == "vnet"
                else "instance norm, dropout")
        log(f"[import] {kind} ({norm}): max |probability diff| vs the "
            f"seeded model on a 112x112x96 crop {diff:.3e} (tol "
            f"{IMPORT_TOL:g}); kernel launches {launches}")
        if not diff <= IMPORT_TOL or any(launches):
            fail(f"import {kind}: the imported model disagrees with the "
                 f"seeded one, or launched kernels {launches}")
        rows[kind] = dict(import_s=wall, max_abs_vs_direct=diff)
        del direct, imported, probs
    return rows


def import_phase(torch, np, epi, sa, ckdir, card):
    """Phase 13: reference checkpoints imported through convert.cli."""
    t0 = time.perf_counter()
    perf = {"brats_segtran3d": import_brats(torch, np, epi, sa, ckdir),
            "fundus_flagship": import_fundus(torch, np, epi, sa, ckdir)}
    torch.cuda.empty_cache()
    perf.update(import_zoo3d(torch, np, epi, sa, ckdir))
    perf["phase_s"] = time.perf_counter() - t0
    log(f"[import] phase in {perf['phase_s']:.1f} s on {card}")
    return perf


# ------------------------------------------------------------ phase 14 ----

# the flagship at fp32 for the receptive-field maps (TF32 off): card
# against CPU, each map relative to its maximum
RF_TOL = 1e-3
# the robustness table with kernels against the unfused modules (bf16):
# Pearson values (features, left/right halves, output) absolutely, the
# perturbed maps' stds relatively
ROBUST_TOL = {"pearson": 2e-2, "std_rel": 2e-2}
ROBUST_FRAMES = 4
PROFILE_BS = 6


def conditioned_init(torch, model, seed):
    """Seeded weights scaled by fan-in (kernels N(0, 1/fan_in),
    attractors and position tables N(0, 1), norm scales 1 + 0.1 N, biases
    0.1 N). Under the reference init the out-squeeze attends nearly
    uniformly and the translayers' outputs hardly vary over the grid: their
    receptive-field gradients sit at rounding level (on the CPU two thread
    counts give maps 100% apart), while these weights give maps that
    agree across thread counts to ~3e-6 of their maximum."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("attractors", "pos_embed", "vfeat_bias"):
                v = torch.randn(p.shape, generator=g)
            elif p.dim() >= 2:
                fan_in = p.shape[1] if p.dim() == 3 else p[0].numel()
                v = torch.randn(p.shape, generator=g) / math.sqrt(fan_in)
            elif leaf == "weight":
                v = 1 + 0.1 * torch.randn(p.shape, generator=g)
            else:
                v = 0.1 * torch.randn(p.shape, generator=g)
            p.copy_(v)
    return model


def tools_model(torch, test2d, train2d, extra, bf16=True, seed=60):
    """The flagship through test2d's factory with ``extra`` flags,
    conditioned_init weights, on the card in eval mode."""
    argv = [a for a in FUNDUS_CLI_ARGV if bf16 or a != "--bf16"]
    args = test2d.build_argparser().parse_args(
        argv + ["--cpdir", "unused"] + extra)
    task = train2d.task_settings(args)
    model, cfg = test2d.build_model(args, task)
    if cfg.translayer_dims != (1792, 1792, 896, 448) \
            or cfg.num_attractors != 256 or cfg.num_modes != 4:
        fail(f"unexpected flagship config {cfg}")
    return conditioned_init(torch, model, seed).cuda().eval(), args, task, cfg


@contextlib.contextmanager
def plain_kernels():
    """Each kernel's plain version in its place on the model's path (aten
    products the FLOP counter sees)."""
    from segtran_tpu_torch.kernels import expansion_epilogue as epi
    from segtran_tpu_torch.kernels import squeezed_attention as sa
    from segtran_tpu_torch.nn import attention

    def flash(q, k, v, attn_clip=500.0, sm_scale=None):
        return sa.fused_cross_attention_plain(q, k, v, attn_clip, sm_scale)[0]
    saved = [(attention, n, getattr(attention, n)) for n in (
        "fused_cross_attention", "fused_cross_attention_trainable")]
    saved += [(epi, n, getattr(epi, n)) for n in (
        "fused_mid_output_pool", "fused_mid_output_pool_permode",
        "fused_private_output_pool")]
    try:
        for mod, n, _ in saved:
            setattr(mod, n, flash if mod is attention
                    else getattr(epi, n + "_plain"))
        yield
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)


def tools_flop(torch, np, epi, sa, logger):
    """(a) test2d's and test3d's --flop (tools/flops.log_flops) at full
    width."""
    from segtran_tpu_torch.cli import test2d, test3d, train2d
    from segtran_tpu_torch.tools.flops import log_flops
    rows = {}
    for label, extra in (("unfused", []), ("fusedepi", ["--fusedepi"]),
                         ("fused", ["--fused", "--fusedepi"])):
        model = tools_model(torch, test2d, train2d, extra)[0]
        reset_counts(epi, sa)
        t0 = time.perf_counter()
        fl = log_flops(model, (1, FUNDUS_SIZE, FUNDUS_SIZE, 3), logger,
                       "GFLOPs/img")
        secs = time.perf_counter() - t0
        rows[label] = dict(gflops=fl["flops"] / 1e9, gbytes=fl["bytes"] / 1e9,
                           launches=list(kernel_launches(epi, sa)),
                           count_s=secs)
        if label == "fused":
            with plain_kernels():
                plain = log_flops(model, (1, FUNDUS_SIZE, FUNDUS_SIZE, 3),
                                  logger, "GFLOPs/img")
            rows["fused_plain_kernels"] = dict(gflops=plain["flops"] / 1e9)
        del model
    un, ep, fu = (rows[k]["gflops"] for k in ("unfused", "fusedepi", "fused"))
    fp = rows["fused_plain_kernels"]["gflops"]
    log(f"[tools] test2d --flop at 288^2, bf16: unfused {un:.3f}, --fusedepi "
        f"{ep:.3f}, --fused --fusedepi {fu:.3f} GFLOPs/img (the same route "
        f"with each kernel's plain version in its place {fp:.3f}); bytes "
        f"{rows['unfused']['gbytes']:.3f} / {rows['fusedepi']['gbytes']:.3f} "
        f"/ {rows['fused']['gbytes']:.3f} GB; launches in the counted "
        f"forward (flash, private, full tier) {rows['fusedepi']['launches']} "
        f"/ {rows['fused']['launches']}; --fused / unfused = {fu / un:.4f} "
        f"(the flash route computes the Q and K projections the unfused "
        f"attention folds into its scores)")
    if not (abs(ep - un) <= 0.01 * un and abs(fu - fp) <= 0.01 * fp):
        fail("--flop: a kernel's FLOPs dropped out of the count")
    if (rows["fusedepi"]["launches"] != [0, 0, 0, 0, 0, 3]
            or rows["fused"]["launches"] != [6, 0, 0, 0, 3, 0]):
        fail(f"--flop: the counted forwards launched "
             f"{rows['fusedepi']['launches']} / {rows['fused']['launches']}")
    args = test3d.build_argparser().parse_args(
        WHOLEVOL_ARGV + ["--fused", "--fusedepi", "--cpdir", "unused"])
    task = test3d.task_settings(args)
    model, cfg = test3d.build_model_and_config(args, task)
    shape = (1,) + tuple(task["input_patch_size"]) + (
        task["orig_in_channels"],)
    reset_counts(epi, sa)
    fl = log_flops(model.cuda().eval(), shape, logger, "GFLOPs/patch")
    launches = kernel_launches(epi, sa)
    log(f"[tools] test3d --flop, BraTS Segtran3d at {shape[1:4]} --fused "
        f"--fusedepi: {fl['flops'] / 1e9:.3f} GFLOPs/patch, "
        f"{fl['bytes'] / 1e9:.3f} GB; launches {launches}")
    if not fl["flops"] > 0 or launches[0] != 2:
        fail(f"test3d --flop: {fl}, launches {launches}")
    rows["test3d_brats"] = dict(gflops=fl["flops"] / 1e9,
                                gbytes=fl["bytes"] / 1e9)
    del model
    torch.cuda.empty_cache()
    return rows


def profiled_count(torch, fn, substr, exclude=None):
    """(device kernels whose name holds ``substr``, wall ms) over one call
    of fn under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and substr in e.key
            and not (exclude and exclude in e.key))
    return n, wall


def tools_rf(torch, np, epi, sa):
    """(b) layer_receptive_fields with --fused at fp32: every kept layer,
    each map timed and its flash launches counted, against the CPU."""
    from segtran_tpu_torch.cli import test2d, train2d
    from segtran_tpu_torch.tools.analysis import layer_receptive_fields
    model = tools_model(torch, test2d, train2d, ["--fused"], bf16=False)[0]
    shape = (FUNDUS_SIZE, FUNDUS_SIZE, 3)
    probe = torch.randn((1,) + shape,
                        generator=torch.Generator().manual_seed(61)) * 0.5
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    maps, rows = {}, {}
    try:
        layer_receptive_fields(model, shape, [0], probe=probe)     # warm-up
        for i in range(4):
            reset_counts(epi, sa)
            box = {}
            n_prof, wall = profiled_count(
                torch, lambda: box.update(layer_receptive_fields(
                    model, shape, [i], probe=probe)), "fwd_kernel", "merge")
            counted = kernel_launches(epi, sa)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            layer_receptive_fields(model, shape, [i], probe=probe)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            (name, m), = box.items()
            maps[name] = m
            rows[name] = dict(ms=ms, flash_launches=counted[0],
                              flash_kernels_profiled=n_prof,
                              recompute_backward=counted[3])
            if counted[0] != 6 or n_prof != 6 or counted[1] or counted[2]:
                fail(f"rf {name}: flash forward launches {counted[0]} "
                     f"(profiler {n_prof}), dK/dV {counted[1]}, dQ "
                     f"{counted[2]}; want 6, 6, 0, 0 per probe")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]
    t0 = time.perf_counter()
    cpu = layer_receptive_fields(model.cpu(), shape, probe=probe)
    cpu_s = time.perf_counter() - t0
    if list(cpu) != ["in_fpn", "layer_0", "layer_1", "layer_2"] \
            or list(maps) != list(cpu):
        fail(f"rf: layers {list(maps)} on the card, {list(cpu)} on the CPU")
    for name, m in maps.items():
        err = float(np.abs(m - cpu[name]).max() / cpu[name].max())
        rows[name]["rel_err_vs_cpu"] = err
        log(f"[tools] rf {name}: {rows[name]['ms']:.1f} ms per map (one "
            f"forward + one backward), flash forward launches "
            f"{rows[name]['flash_launches']} (profiler "
            f"{rows[name]['flash_kernels_profiled']}), recompute backward "
            f"{rows[name]['recompute_backward']}; card vs CPU fp32 max "
            f"|diff| / max {err:.2e} (tol {RF_TOL:g}); max {m.max():.3e}")
        if not (err <= RF_TOL and np.isfinite(m).all()):
            fail(f"rf {name}: the card's map disagrees with the CPU's")
    rows["cpu_all_layers_s"] = cpu_s
    del model
    torch.cuda.empty_cache()
    return rows


def tools_robustness(torch, np, epi, sa, frames, logger):
    """(c) test2d --robust (eval_robustness) on 4 frames with --fusedepi
    and with --fused --fusedepi against the unfused modules."""
    from segtran_tpu_torch.cli import test2d, train2d
    runs, rows = {}, {}
    dev = torch.device("cuda")
    for label, extra in (("unfused", []), ("fusedepi", ["--fusedepi"]),
                         ("fused", ["--fused", "--fusedepi"])):
        model, args, task, cfg = tools_model(torch, test2d, train2d, extra)
        args.robust_sample_num = ROBUST_FRAMES
        reset_counts(epi, sa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[label] = test2d._robustness(model, frames, tuple(
            task["patch_size"]), cfg, args, logger, dev)
        torch.cuda.synchronize()
        rows[label] = dict(s=time.perf_counter() - t0,
                           launches=list(kernel_launches(epi, sa)))
        del model
    forwards = 1 + len(runs["unfused"])
    want = {"fusedepi": [0, 0, 0, 0, 0, 3 * forwards],
            "fused": [6 * forwards, 0, 0, 0, 3 * forwards, 0]}
    ref = runs["unfused"]
    for label in ("fusedepi", "fused"):
        got = runs[label]
        if rows[label]["launches"] != want[label]:
            fail(f"robust {label}: launches {rows[label]['launches']}, want "
                 f"{want[label]} ({forwards} forwards)")
        if [list(v) for v in got.values()] != [list(v) for v in ref.values()]:
            fail(f"robust {label}: keys differ from the unfused run's")
        dp = max(abs(got[p][k] - ref[p][k]) for p in ref for k in ref[p]
                 if not k.startswith("std/"))
        ds = max(abs(got[p][k] - ref[p][k]) / max(abs(ref[p][k]), 1e-12)
                 for p in ref for k in ref[p] if k.startswith("std/"))
        rows[label].update(max_pearson_diff=dp, max_std_rel_diff=ds)
        log(f"[tools] robust {label}: {forwards} forwards of {ROBUST_FRAMES} "
            f"frames in {rows[label]['s']:.2f} s, launches (flash, dK/dV, "
            f"dQ, recompute, private, full) {rows[label]['launches']}; vs "
            f"unfused max |Pearson diff| {dp:.2e} (tol "
            f"{ROBUST_TOL['pearson']:g}), max std rel diff {ds:.2e} (tol "
            f"{ROBUST_TOL['std_rel']:g}) over {sum(map(len, ref.values()))} "
            f"keys")
        if not (dp <= ROBUST_TOL["pearson"] and ds <= ROBUST_TOL["std_rel"]):
            fail(f"robust {label}: disagrees with the unfused modules")
    rows["output_pearson_unfused"] = {p: v["output_pearson"]
                                      for p, v in ref.items()}
    torch.cuda.empty_cache()
    return rows


def _components(np, hard):
    """8-connected foreground components of each frame of a hardened map
    [B, H, W, C] (what --removefrag labels)."""
    from scipy import ndimage
    return [int(ndimage.label(h[..., 1:].any(-1),
                              structure=np.ones((3, 3), np.int32))[1])
            for h in hard.cpu().numpy()]


def tools_eval(torch, np, epi, sa, frames, ckdir, logger):
    """(d) test2d.evaluate_checkpoint with --savefeat 2 --removefrag, with
    --testinterp 72 (and with --removefrag: the ground truth's one disc
    per frame must come through unchanged) and with neither (--fusedepi,
    bf16)."""
    from segtran_tpu_torch.cli import test2d, train2d
    from segtran_tpu_torch.data.labelmaps import harden_segmap
    from segtran_tpu_torch.infer.sliding import sliding_window_2d
    dev = torch.device("cuda")
    model, args, task, cfg = tools_model(torch, test2d, train2d,
                                         ["--fusedepi"])
    mean, std = train2d.load_stats(args, "train")
    rows = {}
    for label, extra in (("plain", []),
                         ("savefeat_removefrag", ["--savefeat", "2",
                                                  "--removefrag"]),
                         ("testinterp", ["--testinterp", "72"]),
                         ("testinterp_removefrag", ["--testinterp", "72",
                                                    "--removefrag"])):
        out = os.path.join(ckdir, f"tools_{label}")
        a = test2d.build_argparser().parse_args(
            FUNDUS_CLI_ARGV + ["--cpdir", out, "--bs", "4", "--vcdr",
                               "--fusedepi"] + extra)
        reset_counts(epi, sa)
        t0 = time.perf_counter()
        res = test2d.evaluate_checkpoint(model, frames, task, a, logger,
                                         mean, std, dev)
        rows[label] = dict(dice=[float(d) for d in res[:2]],
                           vcdr_err=float(res[2]),
                           s=time.perf_counter() - t0,
                           launches=list(kernel_launches(epi, sa)))
        if not np.isfinite(res).all():
            fail(f"test2d {label}: Dice or vCDR not finite")
    npz = os.path.join(ckdir, "tools_savefeat_removefrag",
                       "pixel_features.npz")
    if not os.path.isfile(npz):
        fail("test2d --savefeat wrote no pixel_features.npz")
    dump = np.load(npz)
    rows["savefeat"] = dict(features=list(dump["features"].shape),
                            labels=list(dump["labels"].shape))
    # the components --removefrag sees: the model's predictions (seeded
    # weights) and the --testinterp maps (one disc per frame)
    fn = test2d.make_model_fn(model, mean, std, args.gray_alpha, dev)
    x = torch.from_numpy(np.stack([f["image"] for f in frames])).to(dev)
    raw = torch.from_numpy(np.stack([f["mask"] for f in frames])).to(dev)
    with torch.inference_mode():
        model_hard = harden_segmap(sliding_window_2d(
            fn, x, tuple(task["orig_input_size"]), tuple(task["patch_size"]),
            num_classes=3))
        a.test_interp = "72"
        interp_hard = harden_segmap(test2d._interp_probs(a, task, raw))
    rows["components"] = {}
    for label, hard in (("model", model_hard), ("testinterp", interp_hard)):
        kept = test2d._remove_fragments(hard)
        before, after = _components(np, hard), _components(np, kept)
        single = [i for i, n in enumerate(before) if n <= 1]
        unchanged = all(torch.equal(kept[i], hard[i]) for i in single)
        rows["components"][label] = dict(before=before, after=after,
                                         single_unchanged=unchanged)
        if not unchanged or max(after) > 2:
            fail(f"--removefrag on the {label} maps: components {before} "
                 f"-> {after}, single-component frames unchanged "
                 f"{unchanged}")
    log(f"[tools] test2d evaluate_checkpoint on {len(frames)} 576^2 frames "
        f"(--fusedepi, bf16): Dice / vCDR error plain "
        f"{rows['plain']['dice']} / {rows['plain']['vcdr_err']:.4f}, "
        f"--savefeat 2 --removefrag {rows['savefeat_removefrag']['dice']}, "
        f"--testinterp 72 {rows['testinterp']['dice']}, with --removefrag "
        f"{rows['testinterp_removefrag']['dice']} (launches "
        f"{rows['testinterp']['launches']}); pixel_features.npz features "
        f"{rows['savefeat']['features']}; foreground components per frame "
        f"(before -> after --removefrag): model "
        f"{rows['components']['model']['before']} -> "
        f"{rows['components']['model']['after']}, --testinterp "
        f"{rows['components']['testinterp']['before']} -> "
        f"{rows['components']['testinterp']['after']}")
    if rows["savefeat"]["features"][0] != 2 * (FUNDUS_SIZE // 8) ** 2:
        fail("test2d --savefeat: unexpected dump")
    if any(rows["testinterp"]["launches"]):
        fail("test2d --testinterp launched kernels: it runs no model")
    if rows["components"]["testinterp"]["before"] != [1] * len(frames) or \
            rows["testinterp_removefrag"]["dice"] != rows["testinterp"][
                "dice"]:
        fail("--testinterp --removefrag changed one-disc frames")
    del model
    torch.cuda.empty_cache()
    return rows


def tools_profile(torch, np, epi, sa, ckdir, logger):
    """(e) train2d --profile at bs 6 through train(), then profile_trace
    around one forward."""
    from segtran_tpu_torch.cli import train2d
    from segtran_tpu_torch.nn.init import init_with_reference_schemes
    from segtran_tpu_torch.tools.flops import profile_trace
    dev = torch.device("cuda")
    frames = synthetic_fundus(np, PROFILE_BS, seed=62)
    args = train2d.build_argparser().parse_args(
        FUNDUS_CLI_ARGV + ["--seed", "0", "--bs", str(PROFILE_BS),
                           "--maxiter", "1", "--saveiter", "1",
                           "--profile", "--ckptdir", ckdir])
    task = train2d.task_settings(args)
    model, cfg = train2d.build_model_and_config(args, task)
    model = init_with_reference_schemes(model, cfg, seed=0).to(dev)
    lines = _Lines()
    logger.addHandler(lines)
    t0 = time.perf_counter()
    try:
        train2d.train(model, frames, args, task, dev, cfg,
                      os.path.join(ckdir, "tools_profile"), logger)
        torch.cuda.synchronize()
    finally:
        logger.removeHandler(lines)
    wall = time.perf_counter() - t0
    got = {k: next((ln for ln in lines.lines if ln.startswith(k)), None)
           for k in ("params:", "forward FLOPs:", "forward FPS")}
    if None in got.values():
        fail(f"train2d --profile logged {got}")
    fps = float(got["forward FPS"].split(": ")[1].split()[0])
    trace_dir = os.path.join(ckdir, "trace")
    x = torch.zeros((1, FUNDUS_SIZE, FUNDUS_SIZE, 3), device=dev)
    with profile_trace(trace_dir), torch.inference_mode():
        model.eval()(x)
        torch.cuda.synchronize()
    traces = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    size = sum(os.path.getsize(os.path.join(trace_dir, f)) for f in traces)
    log(f"[tools] train2d --profile --bs {PROFILE_BS} (1 step, "
        f"{wall:.2f} s): {got['params:']}; {got['forward FLOPs:']}; "
        f"{got['forward FPS']}; profile_trace wrote {traces} "
        f"({size / 1e6:.2f} MB)")
    if not (fps > 0 and traces and size > 0):
        fail("train2d --profile / profile_trace: no rate or no trace")
    del model
    torch.cuda.empty_cache()
    return dict(train_s=wall, fps=fps, lines=list(got.values()),
                trace_mb=size / 1e6)


def tools_phase(torch, np, epi, sa, ckdir, logger, card):
    """Phase 14: the analysis tools at the flagship's full width."""
    t0 = time.perf_counter()
    frames = synthetic_fundus(np, ROBUST_FRAMES * 2, seed=63)
    perf = {"flop": tools_flop(torch, np, epi, sa, logger),
            "rf": tools_rf(torch, np, epi, sa),
            "robust": tools_robustness(torch, np, epi, sa,
                                       frames[:ROBUST_FRAMES], logger),
            "eval": tools_eval(torch, np, epi, sa, frames, ckdir, logger),
            "profile": tools_profile(torch, np, epi, sa, ckdir, logger)}
    perf["phase_s"] = time.perf_counter() - t0
    log(f"[tools] phase in {perf['phase_s']:.1f} s on {card}")
    return perf


# ----------------------------------------------------------- phase 15 ----

# (a): train3d at BraTS full width on the 160x192x144 crop (phase 6 (b)),
# bs 1, --fused --dropout 0 under the group; flash launches per step
PAR_TRAIN3D_ARGV = TRAIN_ARGV + ["--bs", "1", "--patchsize", "160,192,144",
                                 "--inputsize", "160,192,144"]
PAR_STEPS = 3
PAR_TRAIN3D_PER_STEP = (2, 1, 1, 1)     # forward, dK/dV, dQ, recompute
# (b): train2d at the flagship's full width, --fused with attention
# dropout off (phase 11's flags); 6 flash forwards per step, no backward
PAR_TRAIN2D_ARGV = FUNDUS_CLI_ARGV + ["--fused", "--dropout", "0"]
PAR_TRAIN2D_PER_STEP = (6, 0, 0)
# (d): the BraTS squeezes: in (Q = 1024 attractors <- N = 8640 tokens,
# D = F = 1024) and out (4 modes, Q = 8640 tokens <- 1024 attractors,
# D = 256, F = 1024), as FLASH_CASES' first two
PAR_CP_CASES = [("in-squeeze", "sharded_cross_attention", 1, 1024, 8640,
                 1024, 1024),
                ("out-squeeze", "token_sharded_expand_attention", 4, 8640,
                 1024, 256, 1024)]
# a step under the group against the same step without one (fp32, TF32
# off): at world size 1 every collective is skipped, so they must agree
# to 1e-5 (the whole gradient by relative Frobenius error)
PAR_FP32_TOL = 1e-5
# ... or within this many times a repeated run's own difference, where
# that is larger (par_fp32_check)
PAR_REPEAT_FACTOR = 3.0
# the sharded whole-volume forward against the model's own (bf16
# probabilities; the same kernels on the same input, cuDNN free to pick
# another convolution algorithm per call)
PAR_PROB_TOL = 1e-3


def free_port():
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def nccl_group(torch):
    """The env a ``torchrun --nproc_per_node 1`` launch sets, then
    ``init_multihost``: an NCCL group of world size 1 or a failure (no
    fallback to gloo or to no group)."""
    import torch.distributed as dist
    from segtran_tpu_torch.parallel.multihost import init_multihost
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
                      RANK="0", LOCAL_RANK="0", WORLD_SIZE="1")
    topo = init_multihost("cuda", verbose=True)
    backend = dist.get_backend() if dist.is_initialized() else None
    log(f"[parallel] init_multihost: {topo}, backend {backend}")
    if backend != "nccl" or topo["process_count"] != 1:
        fail(f"no NCCL group of world size 1: backend {backend}, {topo}")
    return topo


def par_step_ms(torch, steps, batch, draws):
    """{label: [(ms per step, peak GB)]} of each step on ``batch`` with the
    same augmentation ``draws`` (the work of some transforms depends on
    them), in two rounds of turns (plain, group, group, plain): host clock
    around 3 steps after a warm one, ending in a synchronise."""
    out = {label: [] for label in steps}
    order = (list(steps) + list(steps)[::-1]) * 2
    for label in order:
        fn = steps[label]
        fn(batch, draws)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(3):
            fn(batch, draws)
        torch.cuda.synchronize()
        out[label].append(((time.perf_counter() - t0) / 3 * 1e3,
                           torch.cuda.max_memory_allocated() / 1e9))
    return out


def par_train3d(torch, np, epi, sa, ckdir, logger, card):
    """(a): train3d.train() under the group, 3 steps at 160x192x144 bs 1
    (launches per step checked); the step with and without the group
    timed in turns; one fp32 step with the group against one without."""
    from segtran_tpu_torch.cli import train3d
    from segtran_tpu_torch.nn.init import init_with_reference_schemes
    from segtran_tpu_torch.parallel.mesh import TrainMesh
    from segtran_tpu_torch.train.trainer import build_optimizer
    dev = torch.device("cuda")
    make_ds = synthetic_dataset(np, 2, (240, 240, 155))
    args = train3d.build_argparser().parse_args(
        PAR_TRAIN3D_ARGV + ["--bf16", "--ndevices", "1", "--maxiter",
                            str(PAR_STEPS), "--saveiter", str(PAR_STEPS),
                            "--ckptdir", ckdir])
    task = train3d.train_task_settings(args)
    model, cfg = train3d.build_model_and_config(args, task)
    if (cfg.translayer_dims != (1024, 1024) or cfg.num_attractors != 1024
            or cfg.num_modes != 4 or cfg.dtype != torch.bfloat16):
        fail(f"unexpected BraTS training config {cfg}")
    init_with_reference_schemes(model, cfg, seed=0)
    model = model.to(dev)
    ds = make_ds(tuple(task["orig_patch_size"]))
    reset_counts(epi, sa)
    t0 = time.perf_counter()
    ckpt = train3d.train(model, ds, args, task, dev, cfg,
                         os.path.join(ckdir, "par3d"), logger)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = kernel_launches(epi, sa)[:4]
    want = tuple(n * PAR_STEPS for n in PAR_TRAIN3D_PER_STEP)
    wrote = os.path.isfile(os.path.join(ckpt, f"iter_{PAR_STEPS}.pt"))
    log(f"[parallel] (a) train3d.train() under NCCL: {PAR_STEPS} steps in "
        f"{wall:.2f} s; launches (flash forward, dK/dV, dQ, recompute) "
        f"{got}, want {want}; wrote iter_{PAR_STEPS}.pt {wrote}")
    if got != want or not wrote:
        fail("train3d under the group did not launch the flash forward and "
             "backward pair as the path gives them, or wrote no checkpoint")
    batch = {k: torch.from_numpy(np.stack([ds[0][k]])).to(dev)
             for k in ("image", "label")}
    opt = build_optimizer(model, lr=args.lr, decay=args.decay,
                          t_total=args.maxiter, warmup_ratio=0.5)
    plain = train3d.make_step(model, opt, args, task, dev)
    par = TrainMesh(model, opt, 1, 1)
    grouped = par.wrap(train3d.make_step(model, par.optimizer, args, task,
                                         dev))
    draws = {"rot_flip": (torch.tensor([1]), torch.tensor([False]),
                          torch.tensor([True])), "zoom": 1.05}
    times = par_step_ms(torch, {"no group": plain, "NCCL group": grouped},
                        batch, draws)
    for label, rows in times.items():
        log(f"[parallel] (a) train3d step 160x192x144 bs1 bf16, {label}: "
            f"ms per step {[round(r[0], 2) for r in rows]}, peak GB "
            f"{[round(r[1], 2) for r in rows]} on {card}")
    state = {k: v.float() if v.is_floating_point() else v
             for k, v in model.state_dict().items()}
    del model, opt, plain, grouped, par
    torch.cuda.empty_cache()
    fp32 = par_fp32_check(torch, train3d, state, batch, dev)
    return dict(train_wall_s=wall, launches=list(got),
                ms_per_step={k: [r[0] for r in v] for k, v in times.items()},
                peak_mem_gb={k: [r[1] for r in v] for k, v in times.items()},
                **fp32)


def par_fp32_check(torch, train3d, state, batch, dev):
    """One fp32 forward + backward (TF32 off, no update, fixed draws) of
    the (a) batch without the group, with it, and without it again: the
    loss, and the whole gradient (every tensor in one vector) by relative
    Frobenius error against the first run. At world size 1 the group adds
    no arithmetic, but two runs of one step differ too (the trilinear
    resizes' backward sums with atomics, and the I3D backbone's train-mode
    BatchNorm amplifies the reordering), so the group's error is held to
    the larger of PAR_FP32_TOL and PAR_REPEAT_FACTOR times the repeated
    run's; the worst single tensors are logged."""
    from segtran_tpu_torch.parallel.mesh import TrainMesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = train3d.build_argparser().parse_args(PAR_TRAIN3D_ARGV + [
        "--maxiter", "4"])
    task = train3d.train_task_settings(args)
    model, _ = train3d.build_model_and_config(args, task)
    model.load_state_dict(state, strict=True)
    model = model.to(dev)
    draws = {"rot_flip": (torch.tensor([1]), torch.tensor([False]),
                          torch.tensor([True])), "zoom": 1.05}
    runs = {}
    for label in ("no group", "group", "no group again"):
        step = train3d.make_step(model, None, args, task, dev)
        if label == "group":
            step = TrainMesh(model, None, 1, 1).wrap(step)
        metrics = step(batch, draws)
        runs[label] = (float(metrics["loss"]),
                       {n: p.grad.detach().clone()
                        for n, p in model.named_parameters()
                        if p.grad is not None})
    torch.backends.cudnn.allow_tf32 = True
    lb, gb = runs["no group"]
    names = sorted(gb)
    ref = torch.cat([gb[n].reshape(-1) for n in names])

    def against(label):
        la, ga = runs[label]
        if set(ga) != set(gb):
            fail(f"the fp32 step ({label}) has other gradients")
        got = torch.cat([ga[n].reshape(-1) for n in names])
        worst = sorted(((float((ga[n] - gb[n]).norm()
                                / max(float(gb[n].norm()), 1e-30)), n)
                        for n in names), reverse=True)[:3]
        return (abs(la - lb) / abs(lb), float((got - ref).norm()
                                             / ref.norm()), worst)
    loss_rel, rel, worst = against("group")
    loss_rep, rep, worst_rep = against("no group again")
    bound = max(PAR_FP32_TOL, PAR_REPEAT_FACTOR * rep)
    log(f"[parallel] (a) fp32 step with the group vs without: loss rel "
        f"{loss_rel:.2e} (repeat {loss_rep:.2e}); whole gradient relative "
        f"Frobenius error {rel:.2e}, the repeated run's {rep:.2e} (bound "
        f"{bound:.2e}) over {len(names)} tensors; worst tensors "
        f"{[(round(e, 6), n) for e, n in worst]}, repeated "
        f"{[(round(e, 6), n) for e, n in worst_rep]}")
    if loss_rel > max(PAR_FP32_TOL, PAR_REPEAT_FACTOR * loss_rep) \
            or rel > bound:
        fail("the fp32 step under the group disagrees with the one without")
    del model
    torch.cuda.empty_cache()
    return dict(fp32_loss_rel=loss_rel, fp32_grad_fro=rel,
                fp32_repeat_grad_fro=rep)


def par_train2d(torch, np, epi, sa, ckdir, logger, card, cli_ms=None):
    """(b): train2d.train() at the flagship's full width, --fused
    --dropout 0, bs 6, 3 steps under the group (6 flash forwards each);
    the CLI step with and without the group timed in turns."""
    from segtran_tpu_torch.cli import train2d
    from segtran_tpu_torch.data.augment import draw_2d
    from segtran_tpu_torch.nn.init import init_with_reference_schemes
    from segtran_tpu_torch.parallel.mesh import TrainMesh
    from segtran_tpu_torch.train.trainer import build_optimizer
    dev = torch.device("cuda")
    frames = synthetic_fundus(np, 2 * CLI_BS, seed=31)
    args = train2d.build_argparser().parse_args(
        PAR_TRAIN2D_ARGV + ["--seed", "0", "--bs", str(CLI_BS), "--ndevices",
                            "1", "--maxiter", str(PAR_STEPS), "--saveiter",
                            str(PAR_STEPS), "--logiter", "1", "--ckptdir",
                            ckdir])
    task = train2d.task_settings(args)
    model, cfg = train2d.build_model_and_config(args, task)
    if (cfg.translayer_dims != (1792, 1792, 896, 448) or cfg.num_modes != 4
            or cfg.num_attractors != 256 or cfg.dtype != torch.bfloat16
            or cfg.attention_probs_dropout_prob != 0):
        fail(f"unexpected train2d flagship config {cfg}")
    init_with_reference_schemes(model, cfg, seed=0)
    model = model.to(dev)
    reset_counts(epi, sa)
    t0 = time.perf_counter()
    ckpt = train2d.train(model, frames, args, task, dev, cfg,
                         os.path.join(ckdir, "par2d"), logger)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = kernel_launches(epi, sa)[:3]
    want = tuple(n * PAR_STEPS for n in PAR_TRAIN2D_PER_STEP)
    wrote = os.path.isfile(os.path.join(ckpt, f"iter_{PAR_STEPS}.pt"))
    log(f"[parallel] (b) train2d.train() --fused under NCCL: {PAR_STEPS} "
        f"steps at bs {CLI_BS} in {wall:.2f} s; launches (flash forward, "
        f"dK/dV, dQ) {got}, want {want}; wrote iter_{PAR_STEPS}.pt {wrote}")
    if got != want or not wrote:
        fail("train2d --fused under the group did not launch the flash "
             "forward 6 times per step, or wrote no checkpoint")
    batch = {k: torch.from_numpy(np.stack([f[k] for f in frames[:CLI_BS]]))
             .to(dev) for k in ("image", "mask")}
    opt = build_optimizer(model, lr=2e-4, decay=1e-4, t_total=100,
                          warmup_ratio=0.05)
    plain = train2d.make_step(model, opt, args, task, dev)
    par = TrainMesh(model, opt, 1, 1)
    grouped = par.wrap(train2d.make_step(model, par.optimizer, args, task,
                                         dev))
    aug_cfg = train2d.aug_config(args, *train2d.load_stats(
        args, train2d.dataset_names(args, task)[0]))
    draws = draw_2d(CLI_BS, aug_cfg,
                    torch.Generator(device=dev).manual_seed(7))
    times = par_step_ms(torch, {"no group": plain, "NCCL group": grouped},
                        batch, draws)
    for label, rows in times.items():
        log(f"[parallel] (b) train2d --fused step bs{CLI_BS} bf16, {label}: "
            f"ms per step {[round(r[0], 2) for r in rows]}, peak GB "
            f"{[round(r[1], 2) for r in rows]} on {card}")
    log(f"[parallel] (b) phase 8's CLI step (no --fused) in this call: "
        + (f"{cli_ms:.2f} ms" if cli_ms else "not run in this call"))
    del model, opt, plain, grouped, par
    torch.cuda.empty_cache()
    return dict(train_wall_s=wall, launches=list(got),
                ms_per_step={k: [r[0] for r in v] for k, v in times.items()},
                peak_mem_gb={k: [r[1] for r in v] for k, v in times.items()},
                phase8_cli_ms=cli_ms)


def par_spatial(torch, np, epi, sa, ckdir, card):
    """(c): sharded_whole_volume_apply on a (data 1, model 1) mesh for a
    160x192x144 volume with --fused --fusedepi: 2 flash forwards and 1
    private-tier launch, probabilities equal to evaluate_volume's forward;
    evaluate_volume through the sharded function."""
    from segtran_tpu_torch.cli.test3d import (WHOLEVOL_MULTIPLES,
                                              build_argparser,
                                              build_model_and_config,
                                              evaluate_volume, task_settings)
    from segtran_tpu_torch.models.segtran3d import init_segtran3d
    from segtran_tpu_torch.parallel.mesh import make_mesh
    from segtran_tpu_torch.parallel.spatial import (sharded_whole_volume_apply,
                                                    volume_slab)
    dev = torch.device("cuda")
    args = build_argparser().parse_args(
        WHOLEVOL_ARGV + ["--fused", "--fusedepi", "--spatialshard",
                         "--cpdir", ckdir])
    task = task_settings(args)
    model, _ = build_model_and_config(args, task)
    model = init_segtran3d(model, seed=0).to(dev).eval()
    mesh = make_mesh(1, axes=("data", "model"), shape=(1, 1))
    fn = sharded_whole_volume_apply(model, mesh)
    sample = synthetic_volume(np, (160, 192, 144), seed=5)
    vol = torch.from_numpy(sample["image"])[None].to(dev)
    pads = [(-s) % m for s, m in zip(vol.shape[1:4], WHOLEVOL_MULTIPLES)]
    volp = torch.nn.functional.pad(vol, (0, 0, 0, pads[2], 0, pads[1], 0,
                                         pads[0]))
    fn(volume_slab(volp, mesh))                              # warm
    torch.cuda.synchronize()
    reset_counts(epi, sa)
    t0 = time.perf_counter()
    logits = fn(volume_slab(volp, mesh))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = kernel_launches(epi, sa)
    launches = (got[0], got[4])
    with torch.inference_mode():
        ref = model(volp)
    diff = float((torch.sigmoid(logits.float())
                  - torch.sigmoid(ref.float())).abs().max())
    probs, _, metrics = evaluate_volume(fn, sample, args, task, dev)
    probs_ref, _, metrics_ref = evaluate_volume(model, sample, args, task,
                                                dev)
    pdiff = float((probs - probs_ref).abs().max())
    log(f"[parallel] (c) sharded_whole_volume_apply 160x192x144 --fused "
        f"--fusedepi bf16: {secs:.3f} s, launches (flash forward, private "
        f"tier) {launches}, want (2, 1); max |probability diff| against the "
        f"model's forward {diff:.2e}, through evaluate_volume {pdiff:.2e}; "
        f"dice {[round(d, 4) for d in metrics['dice']]} vs "
        f"{[round(d, 4) for d in metrics_ref['dice']]} on {card}")
    dice_gap = max(abs(a - b) for a, b in zip(metrics["dice"],
                                              metrics_ref["dice"]))
    if launches != (2, 1) or max(diff, pdiff) > PAR_PROB_TOL \
            or dice_gap > DICE_TOL:
        fail("the sharded whole-volume forward disagrees with the model's "
             "or did not launch 2 flash forwards and 1 private tier")
    del model, logits, ref
    torch.cuda.empty_cache()
    return dict(seconds=secs, launches=list(launches), prob_diff=diff)


def par_context(torch, sa, card):
    """(d): the context-parallel squeeze and expand at the BraTS shapes,
    bf16 and fp32 (TF32 off), each against the plain flash version and
    timed beside a bare fused_cross_attention call of the same shape."""
    import torch.distributed as dist
    from segtran_tpu_torch.parallel import context_parallel as cp
    torch.backends.cuda.matmul.allow_tf32 = False
    group = dist.group.WORLD
    rows = []
    for dname, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        for i, (label, name, g, nq, n, d, f) in enumerate(PAR_CP_CASES):
            gen = torch.Generator(device="cuda").manual_seed(500 + i)

            def rn(*shape):
                return torch.randn(*shape, generator=gen,
                                   device="cuda").to(dt)
            q, k, v = rn(g, nq, d), rn(g, n, d), rn(g, n, f)
            fn = getattr(cp, name)
            sa.reset_launches()
            out = fn(q, k, v, group)
            torch.cuda.synchronize()
            launches = sa.fused_cross_attention.launches
            ref, _ = sa.fused_cross_attention_plain(q, k, v, 500.0,
                                                    1.0 / math.sqrt(d))
            err = (out.float() - ref.float()).abs()
            rel = float((err / (1 + ref.float().abs())).max())
            mean = float(err.mean())
            ms = cuda_ms(torch, lambda: fn(q, k, v, group), iters=5)
            bare = cuda_ms(torch, lambda: sa.fused_cross_attention(q, k, v),
                           iters=5)
            tol_max, tol_mean = KERNEL_TOL[dname]
            log(f"[parallel] (d) {name} {label} {dname} G={g} Q={nq} N={n} "
                f"D={d} F={f}: {launches} launch(es), max rel err {rel:.2e} "
                f"mean {mean:.2e} (tol {tol_max:g} / {tol_mean:g}); "
                f"{ms:.3f} ms beside a bare fused_cross_attention "
                f"{bare:.3f} ms on {card}")
            if launches != 1 or rel > tol_max or mean > tol_mean:
                fail(f"{name} {label} {dname} disagrees with the plain "
                     f"flash version or did not launch the kernel once")
            rows.append(dict(name=name, shape=[g, nq, n, d, f], dtype=dname,
                             launches=launches, max_rel_err=rel, ms=ms,
                             bare_ms=bare))
    return rows


def parallel_phase(torch, np, epi, sa, ckdir, logger, card, cli_ms=None):
    """Phase 15: parallel/ on an NCCL group of world size 1."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    nccl_group(torch)
    try:
        perf = {"train3d": par_train3d(torch, np, epi, sa, ckdir, logger,
                                       card),
                "train2d": par_train2d(torch, np, epi, sa, ckdir, logger,
                                       card, cli_ms),
                "spatial": par_spatial(torch, np, epi, sa, ckdir, card),
                "context": par_context(torch, sa, card)}
    finally:
        dist.destroy_process_group()
        for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "LOCAL_RANK",
                    "WORLD_SIZE"):
            os.environ.pop(key, None)
    perf["phase_s"] = time.perf_counter() - t0
    log(f"[parallel] phase in {perf['phase_s']:.1f} s on {card}")
    return perf


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="smoke run of the port on one "
                                             "GPU; no arguments runs every "
                                             "phase")
    ap.add_argument("--only", choices=["epilogue", "flash",
                                       "flash_backward",
                                       "training", "mbconv",
                                       "fundus_training", "fundus_cli",
                                       "fundus_options", "volume_options",
                                       "da", "zoo", "import", "tools",
                                       "parallel"],
                    default=None,
                    help="build and run only this check, print no result")
    only = ap.parse_args(argv).only
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "segtran_tpu_torch", "csrc")):
        print("chip_smoke: the port's sources are not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    from segtran_tpu_torch.kernels import _build
    from segtran_tpu_torch.kernels import expansion_epilogue as epi
    from segtran_tpu_torch.kernels import mbconv as mb
    from segtran_tpu_torch.kernels import squeezed_attention as sa

    t_all = time.perf_counter()
    card = card_line(torch)
    log(f"[build] card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build(_build.all_sources())
    log(f"[build] {len(_build.all_sources())} source(s) in "
        f"{time.perf_counter() - t0:.1f} s")
    for src, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {src}: {line.strip()}")

    logger = logging.getLogger("chip_smoke")
    logger.addHandler(logging.StreamHandler(sys.stderr))
    logger.setLevel(logging.INFO)
    ckdir = os.path.join(ROOT, "build", "chip_smoke")
    if only == "epilogue":
        rows = check_kernels(torch, epi)
        print(json.dumps({"epilogue": rows, "card": card}), flush=True)
        return 0
    if only == "flash":
        rows = check_flash(torch, sa)
        print(json.dumps({"flash": rows, "card": card}), flush=True)
        return 0
    if only == "flash_backward":
        rows = check_flash_backward(torch, sa)
        print(json.dumps({"flash_backward": rows, "card": card}), flush=True)
        return 0
    if only == "mbconv":
        rows = check_mbconv(torch, mb)
        bb_perf, _ = backbone_fused(torch, mb)
        print(json.dumps({"mbconv": rows, "backbone": bb_perf, "card": card}),
              flush=True)
        return 0
    if only == "fundus_training":
        perf = fundus_training(torch)
        print(json.dumps({"fundus_train": perf, "card": card}), flush=True)
        return 0
    if only == "fundus_cli":
        try:
            perf = fundus_cli(torch, np, epi, sa, ckdir, logger)
        finally:
            shutil.rmtree(ckdir, ignore_errors=True)
        print(json.dumps({"fundus_cli": perf, "card": card}), flush=True)
        return 0
    if only == "fundus_options":
        try:
            perf = fundus_options(torch, np, epi, sa, ckdir, logger)
        finally:
            shutil.rmtree(ckdir, ignore_errors=True)
        print(json.dumps({"fundus_options": perf, "card": card}), flush=True)
        return 0
    if only == "volume_options":
        try:
            perf = volume_options(torch, np, epi, sa, ckdir, logger)
        finally:
            shutil.rmtree(ckdir, ignore_errors=True)
        print(json.dumps({"volume_options": perf, "card": card}), flush=True)
        return 0
    if only == "da":
        try:
            perf = da_phase(torch, np, epi, sa, ckdir, logger)
        finally:
            shutil.rmtree(ckdir, ignore_errors=True)
        print(json.dumps({"da": perf, "card": card}), flush=True)
        return 0
    if only == "zoo":
        try:
            perf = zoo_phase(torch, np, epi, sa, ckdir, logger, card)
        finally:
            shutil.rmtree(ckdir, ignore_errors=True)
        print(json.dumps({"zoo": perf, "card": card}), flush=True)
        return 0
    if only == "import":
        try:
            perf = import_phase(torch, np, epi, sa, ckdir, card)
        finally:
            shutil.rmtree(ckdir, ignore_errors=True)
        print(json.dumps({"import": perf, "card": card}), flush=True)
        return 0
    if only == "tools":
        try:
            perf = tools_phase(torch, np, epi, sa, ckdir, logger, card)
        finally:
            shutil.rmtree(ckdir, ignore_errors=True)
        print(json.dumps({"tools": perf, "card": card}), flush=True)
        return 0
    if only == "parallel":
        try:
            perf = parallel_phase(torch, np, epi, sa, ckdir, logger, card)
        finally:
            shutil.rmtree(ckdir, ignore_errors=True)
        print(json.dumps({"parallel": perf, "card": card}), flush=True)
        return 0
    if only == "training":
        try:
            train_perf, _ = training(torch, np, sa, ckdir, logger)
        finally:
            shutil.rmtree(ckdir, ignore_errors=True)
        print(json.dumps({"training": train_perf, "card": card}), flush=True)
        return 0
    kernels = (check_kernels(torch, epi) + check_flash(torch, sa)
               + check_flash_backward(torch, sa))
    try:
        perf, launches, state, cfg, batch = serve(torch, np, epi, sa, mb,
                                                  ckdir, logger)
        log(f"[serving] {json.dumps(perf)} on {card}")
        nonreassociated(torch, np, epi, state, cfg, batch)
        del state
        shutil.rmtree(ckdir, ignore_errors=True)
        vol_perf, vol_launches = wholevol(torch, np, epi, sa, ckdir, logger)
        log(f"[wholevol] {json.dumps(vol_perf)} on {card}")
        launches.update(vol_launches)
        shutil.rmtree(ckdir, ignore_errors=True)
        train_perf, (_, n_dkdv, n_dq, _) = training(torch, np, sa, ckdir,
                                                   logger)
        log(f"[train] {json.dumps(train_perf)} on {card}")
        launches.update(flash_backward_dkdv=n_dkdv, flash_backward_dq=n_dq)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    kernels += check_mbconv(torch, mb)
    bb_perf, launches["mbconv_front"] = backbone_fused(torch, mb)
    log(f"[mbconv] {json.dumps(bb_perf)} on {card}")
    fundus_perf = fundus_training(torch)
    bs6 = fundus_perf.get(f"bs{FUNDUS_TRAIN_CASES[0][0]} remat_blocks on", {})
    try:
        cli_perf = fundus_cli(torch, np, epi, sa, ckdir, logger,
                              bs6.get("ms_per_step"))
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    log(f"[fundus_cli] {json.dumps(cli_perf)} on {card}")
    try:
        options_perf = fundus_options(torch, np, epi, sa, ckdir, logger)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    log(f"[fundus_options] {json.dumps(options_perf)} on {card}")
    try:
        volume_perf = volume_options(torch, np, epi, sa, ckdir, logger)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    log(f"[volume_options] {json.dumps(volume_perf)} on {card}")
    try:
        da_perf = da_phase(torch, np, epi, sa, ckdir, logger)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    log(f"[da] {json.dumps(da_perf)} on {card}")
    try:
        zoo_perf = zoo_phase(torch, np, epi, sa, ckdir, logger, card)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    log(f"[zoo] {json.dumps(zoo_perf)} on {card}")
    try:
        import_perf = import_phase(torch, np, epi, sa, ckdir, card)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    log(f"[import] {json.dumps(import_perf)} on {card}")
    try:
        tools_perf = tools_phase(torch, np, epi, sa, ckdir, logger, card)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    log(f"[tools] {json.dumps(tools_perf)} on {card}")
    try:
        par_perf = parallel_phase(torch, np, epi, sa, ckdir, logger, card,
                                  cli_perf.get("ms_per_step"))
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    log(f"[parallel] {json.dumps(par_perf)} on {card}")

    replaces = {
        "fused_mid_output_pool": "segtran_tpu/kernels/expansion_epilogue.py:333",
        "fused_mid_output_pool_permode":
            "segtran_tpu/kernels/expansion_epilogue.py:226",
        "fused_private_output_pool":
            "segtran_tpu/kernels/expansion_epilogue.py:289",
        "fused_cross_attention": "segtran_tpu/kernels/squeezed_attention.py:107",
        "flash_backward_dkdv": "segtran_tpu/kernels/squeezed_attention.py:204",
        "flash_backward_dq": "segtran_tpu/kernels/squeezed_attention.py:234",
        "mbconv_front": "segtran_tpu/kernels/mbconv.py:146"}
    # one entry per kernel: bf16 at the first shape of each (the flash
    # kernels: the in-squeeze at N=8640; mbconv_front: H=144 k3 32->192),
    # the private tier at the BraTS volume mid [1,4,8640,1024];
    # launches from the main path of its slice (serving for the first two,
    # the whole-volume run for the next two, the 160x192x144 train steps for
    # the backward pair, one batch-8 forward of the fused-eval eff-b4
    # backbone for mbconv_front); every measured row is printed above
    entries = []
    for name in ("fused_mid_output_pool_permode", "fused_mid_output_pool",
                 "fused_private_output_pool", "fused_cross_attention",
                 "flash_backward_dkdv", "flash_backward_dq", "mbconv_front"):
        r = next(k for k in kernels if k["name"] == name
                 and k["dtype"] == "bf16"
                 and (name != "fused_private_output_pool"
                      or k["shape"] == [1, 4, 8640, 0, 1024]))
        src = ("expansion_epilogue" if "output_pool" in name
               else "mbconv" if name == "mbconv_front"
               else "squeezed_attention")
        entries.append(dict(
            name=name, route="cuda",
            source=f"segtran_tpu_torch/csrc/{src}.cu",
            replaces=replaces[name], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r.get("library_ms")))
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"fundus_train": fundus_perf, "backbone": bb_perf,
                      "card": card}), flush=True)
    print(json.dumps({"kernels": entries, "card": card}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
